"""Config for --arch kimi-k2-1t-a32b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["kimi-k2-1t-a32b"]
REDUCED = reduced(CONFIG)
