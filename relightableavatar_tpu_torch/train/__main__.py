"""``python -m relightableavatar_tpu_torch.train``: see :mod:`.cli`."""
from relightableavatar_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
