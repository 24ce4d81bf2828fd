"""Config for --arch recurrentgemma-2b (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["recurrentgemma-2b"]
REDUCED = reduced(CONFIG)
