"""Architecture registry: one module per served architecture."""
from repro_torch.configs.registry import ARCHS, get_config
