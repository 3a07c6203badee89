"""PyTorch port of surs_tpu's serving path for NVIDIA Hopper.

Runs on CUDA by default (entry points take ``device="cpu"`` to opt out);
the point MLP runs as the hand-written CUDA kernel K1
(``ops/fused_mlp.py``, ``csrc/fused_dual_mlp.cu``).
"""
