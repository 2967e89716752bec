"""`python -m samplenerfro_torch.train`: see train/loop.py."""

from samplenerfro_torch.train import loop

if __name__ == "__main__":
  loop.main()
