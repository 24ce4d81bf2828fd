"""Config for --arch llava-next-mistral-7b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["llava-next-mistral-7b"]
REDUCED = reduced(CONFIG)
