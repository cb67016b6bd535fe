from .registry import (ARCHS, SHAPES, get_config, get_smoke_config,
                       shape_cells, smoke_batch)
