from action_segmentation_torch.utils.logger import logger, path_logger
from action_segmentation_torch.utils.misc import all_equal, load_pickle, nested_dict_map

__all__ = ["logger", "path_logger", "all_equal", "load_pickle", "nested_dict_map"]
