from .confignode import ConfigNode, load_yaml, merge, from_dotlist, to_dict
from .defaults import default_config, default_infer_config, load_config

__all__ = [
    "ConfigNode",
    "load_yaml",
    "merge",
    "from_dotlist",
    "to_dict",
    "default_config",
    "default_infer_config",
    "load_config",
]
