"""Config for --arch arctic-480b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["arctic-480b"]
REDUCED = reduced(CONFIG)
