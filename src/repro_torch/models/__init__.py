from .config import (DeepSeekMoEConfig, MLAConfig, ModelConfig, MoEConfig, SSMConfig,
                     param_count)
from .model import Model
