"""Framework-wide constants.

Mirrors the semantics of the reference's
``modules/dense_correspondence_manipulation/utils/constants.py:1-20``:
depth images are uint16 millimetres (scale 1000 to metres) and RGB inputs are
normalized with ImageNet statistics before entering the network.
"""

# uint16 depth image encoding: value / DEPTH_IM_SCALE = metres
DEPTH_IM_SCALE = 1000.0

# Occlusion margin used when checking reprojected depth consistency (metres).
# Reference: correspondence_finder.py:599
OCCLUSION_MARGIN = 0.003

# ImageNet RGB statistics (reference: constants.py, used by the dataset's
# ToTensor+Normalize transform).
DEFAULT_IMAGE_MEAN = (0.485, 0.456, 0.406)
DEFAULT_IMAGE_STD = (0.229, 0.224, 0.225)

# Default image geometry of the pdc dataset
DEFAULT_IMAGE_WIDTH = 640
DEFAULT_IMAGE_HEIGHT = 480
