"""Config for --arch starcoder2-3b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["starcoder2-3b"]
REDUCED = reduced(CONFIG)
