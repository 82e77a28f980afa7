from .checkpoint import restore_params
