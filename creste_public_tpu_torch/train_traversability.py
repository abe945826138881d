"""Stage-3 training CLI: MaxEnt IRL (+ counterfactual) reward learning over
the frozen TerrainNet backbone (reference train_traversability.py:333-425).

Usage:
  python -m creste_public_tpu_torch.train_traversability trainer=smoke \\
      trainer.ckpt_dir=ckpts/stage3 model.weights_path=ckpts/stage2
  python -m creste_public_tpu_torch.train_traversability trainer=smoke \\
      model=traversability/tiny dataset=synthetic_tiny trainer.device=cpu
"""
from creste_public_tpu_torch.cli import launch


def main(argv=None):
    return launch("traversability", argv)


if __name__ == "__main__":
    main()
