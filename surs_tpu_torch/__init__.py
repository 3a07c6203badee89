"""PyTorch port of surs_tpu's serving and training paths for NVIDIA
Hopper.

Runs on CUDA by default (entry points take ``device="cpu"`` to opt out);
the point MLPs run as the hand-written CUDA kernels K1 (serving) and K2
(the fused train step) (``ops/fused_mlp.py``, ``csrc/fused_dual_mlp.cu``).
"""
