from .config import ModelConfig, MoEConfig, SSMConfig, param_count
from .model import Model
