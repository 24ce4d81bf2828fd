"""Config for --arch qwen2-1.5b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["qwen2-1.5b"]
REDUCED = reduced(CONFIG)
