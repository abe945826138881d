"""Stage-2 training CLI: TerrainNet trained end to end on the SAM-instance
contrastive, BEV semantic, elevation, depth and DINO-distillation losses
(reference train_ssc.py:271-367).

Usage:
  python -m creste_public_tpu_torch.train_ssc trainer=smoke \\
      trainer.ckpt_dir=ckpts/stage2 model.weights_path=ckpts/stage1
  python -m creste_public_tpu_torch.train_ssc trainer=smoke \\
      model=ssc_sam/tiny dataset=synthetic_tiny trainer.device=cpu
"""
from creste_public_tpu_torch.cli import launch


def main(argv=None):
    return launch("ssc_sam", argv)


if __name__ == "__main__":
    main()
