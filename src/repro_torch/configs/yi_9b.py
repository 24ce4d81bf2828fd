"""Config for --arch yi-9b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["yi-9b"]
REDUCED = reduced(CONFIG)
