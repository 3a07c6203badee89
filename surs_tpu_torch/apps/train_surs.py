"""Train the model on an on-disk dataset (counterpart of
``apps/train_surs.py``, the same flags, plus ``--device``).

  python -m surs_tpu_torch.apps.train_surs --dataroot <data> --name exp \
      --residual --random_flip --random_scale --random_trans \
      --num_sample_inout 6000 --sigma 5.0 --batch_size 2 --fused_train

``<dataroot>`` holds RENDER/, MASK/, PARAM/, GEO/OBJ/ and optionally
val.txt and SAMPLE_CACHE/ (``data/datasets.py``), views at every yaw
degree unless ``--yaw_list`` names the yaws rendered. Checkpoints go to
``<checkpoints_path>/<name>/``, the epoch meshes and PLY dumps to
``<results_path>/<name>/``. Runs on CUDA and raises without a GPU;
``--device cpu`` runs on the CPU. ``--fused_train`` takes the fused step
(kernel K2) on the card.
"""

from __future__ import annotations


def main(argv=None) -> dict:
    from ..config import build_parser, config_from_args, print_config
    from ..train.loop import train

    parser = build_parser()
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA")
    parser.add_argument("--yaw_list", type=int, nargs="+", default=None,
                        help="the yaws of the dataset's views; default "
                        "0..359")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    print(print_config(cfg))
    return train(cfg, device=args.device, yaw_list=args.yaw_list)


if __name__ == "__main__":
    main()
