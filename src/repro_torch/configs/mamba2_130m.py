"""Config for --arch mamba2-130m (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["mamba2-130m"]
REDUCED = reduced(CONFIG)
