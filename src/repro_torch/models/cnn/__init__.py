"""Model zoo: CNNs of the paper's Table 2 as Graph IR builders."""
from repro_torch.models.cnn.zoo import MODELS, build

__all__ = ["MODELS", "build"]
