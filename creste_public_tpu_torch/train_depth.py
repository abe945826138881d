"""Stage-0 training CLI: depth completion alone, DepthCompletionModel
trained on the depth classification and regression losses (reference
CODatasetDepth/CODaDepthModule, coda_dataloader_depth.py:23,
dataloader.py:17).

Usage:
  python -m creste_public_tpu_torch.train_depth trainer=smoke \\
      trainer.ckpt_dir=ckpts/stage0
  python -m creste_public_tpu_torch.train_depth trainer=smoke \\
      dataset=synthetic_tiny model.batch_size=2 trainer.device=cpu
"""
from creste_public_tpu_torch.cli import launch


def main(argv=None):
    return launch("depth", argv)


if __name__ == "__main__":
    main()
