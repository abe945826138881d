"""Stage-1 training CLI: RGB-D depth completion + DINOv2 feature
distillation, DistillationBackbone trained on the depth losses and the
feature MSE (reference train_pefree.py:202-313). Its checkpoint grafts into
stage 2 (``train_ssc model.weights_path=...``).

Usage:
  python -m creste_public_tpu_torch.train_pefree trainer=smoke \\
      trainer.ckpt_dir=ckpts/stage1
  python -m creste_public_tpu_torch.train_pefree trainer=smoke \\
      model=distillation/tiny dataset=synthetic_tiny trainer.device=cpu
"""
from creste_public_tpu_torch.cli import launch


def main(argv=None):
    return launch("distillation", argv)


if __name__ == "__main__":
    main()
