from .config import Config, as_config
from .seed import seed_all

__all__ = ["Config", "as_config", "seed_all"]
