from action_segmentation_torch.utils.logger import logger
from action_segmentation_torch.utils.misc import all_equal, load_pickle, nested_dict_map

__all__ = ["logger", "all_equal", "load_pickle", "nested_dict_map"]
