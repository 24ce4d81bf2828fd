"""Config for --arch stablelm-3b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["stablelm-3b"]
REDUCED = reduced(CONFIG)
