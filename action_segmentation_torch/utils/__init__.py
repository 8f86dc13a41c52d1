from action_segmentation_torch.utils.logger import logger
from action_segmentation_torch.utils.misc import all_equal

__all__ = ["logger", "all_equal"]
