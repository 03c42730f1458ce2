"""Built-in COCO category tables for label rendering without dataset files.

The reference gets class names from detectron2's hardcoded builtin metadata
(detectron2 builtin_meta.py, used by demo/demo.py:39 via
MetadataCatalog.get(cfg.DATASETS.TEST[0])); our dataset registrations build
names lazily from the annotation json, which a demo machine may not have.
These are the standard public COCO category names in contiguous-id order:

* ``COCO_THING_CLASSES``: the 80 detection/instance categories, contiguous
  ids 0..79 (json ids 1..90 with gaps, sorted ascending).
* ``COCO_PANOPTIC_CLASSES``: the 133 panoptic categories in contiguous
  order — the panoptic json lists the 80 thing ids (1..90) before the 53
  stuff ids (92..200), so contiguous 0..79 are things and 80..132 stuff.
* ``COCO_PANOPTIC_ISTHING``: matching per-contiguous-id thing flags.
"""

from __future__ import annotations

COCO_THING_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]

COCO_PANOPTIC_STUFF_CLASSES = [
    "banner", "blanket", "bridge", "cardboard", "counter", "curtain",
    "door-stuff", "floor-wood", "flower", "fruit", "gravel", "house",
    "light", "mirror-stuff", "net", "pillow", "platform", "playingfield",
    "railroad", "river", "road", "roof", "sand", "sea", "shelf", "snow",
    "stairs", "tent", "towel", "wall-brick", "wall-stone", "wall-tile",
    "wall-wood", "water-other", "window-blind", "window-other",
    "tree-merged", "fence-merged", "ceiling-merged", "sky-other-merged",
    "cabinet-merged", "table-merged", "floor-other-merged",
    "pavement-merged", "mountain-merged", "grass-merged", "dirt-merged",
    "paper-merged", "food-other-merged", "building-other-merged",
    "rock-merged", "wall-other-merged", "rug-merged",
]

COCO_PANOPTIC_CLASSES = COCO_THING_CLASSES + COCO_PANOPTIC_STUFF_CLASSES
COCO_PANOPTIC_ISTHING = [True] * len(COCO_THING_CLASSES) + [False] * len(
    COCO_PANOPTIC_STUFF_CLASSES
)

assert len(COCO_THING_CLASSES) == 80
assert len(COCO_PANOPTIC_CLASSES) == 133


def default_demo_metadata(num_classes: int):
    """(class_names, thing_mask) for demo rendering when no dataset metadata
    is available: COCO instance (80) and COCO panoptic (133) are recognized;
    anything else falls back to numeric labels / all-things."""
    if num_classes == len(COCO_PANOPTIC_CLASSES):
        return COCO_PANOPTIC_CLASSES, tuple(COCO_PANOPTIC_ISTHING)
    if num_classes == len(COCO_THING_CLASSES):
        return COCO_THING_CLASSES, tuple([True] * num_classes)
    return None, tuple([True] * num_classes)
