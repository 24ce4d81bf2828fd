"""Config for --arch whisper-tiny (see archs.py for the table)."""
from repro_torch.configs.archs import ARCHS, reduced

CONFIG = ARCHS["whisper-tiny"]
REDUCED = reduced(CONFIG)
