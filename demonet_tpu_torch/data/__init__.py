"""Datasets, augmentations, loaders, evaluators (counterpart of
demonet_tpu/data/; reference demonet/data/). numpy, with cv2 and PIL
imported only where an image is resized, colour-jittered or read from
disk."""

from demonet_tpu_torch.data.coco import (  # noqa: F401
    COCO_CLASSES,
    CocoDetection,
    get_coco,
    get_coco_kp,
)
from demonet_tpu_torch.data.group_by_aspect_ratio import (  # noqa: F401
    GroupedBatchSampler,
    compute_aspect_ratios,
    create_aspect_ratio_groups,
)
from demonet_tpu_torch.data.voc import VOC_CLASSES, VOCDetection  # noqa: F401
from demonet_tpu_torch.data.coco_eval import CocoEvaluator  # noqa: F401
from demonet_tpu_torch.data.voc_eval import (  # noqa: F401
    VocEvaluator,
    voc_ap,
    voc_eval,
)
from demonet_tpu_torch.data.loader import DetectionLoader  # noqa: F401
from demonet_tpu_torch.data.presets import (  # noqa: F401
    DetectionPresetEval,
    DetectionPresetTrain,
)
