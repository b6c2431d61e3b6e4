"""ScanNet's NYU40 palette (a copy of ``scan2cap_tpu/utils/colors.py``;
reference scripts/colors.py), byte for byte, so PLYs written by the port
carry the reference's colours; ``object_color`` is the reference's
per-object rule (scripts/visualize.py:375)."""

NYU40_COLORS = [
    [174, 199, 232],   # wall
    [152, 223, 138],   # floor
    [31, 119, 180],    # cabinet
    [255, 187, 120],   # bed
    [188, 189, 34],    # chair
    [140, 86, 75],     # sofa
    [255, 152, 150],   # table
    [214, 39, 40],     # door
    [197, 176, 213],   # window
    [148, 103, 189],   # bookshelf
    [196, 156, 148],   # picture
    [23, 190, 207],    # counter
    [178, 76, 76],     # blinds
    [247, 182, 210],   # desk
    [66, 188, 102],    # shelves
    [219, 219, 141],   # curtain
    [140, 57, 197],    # dresser
    [202, 185, 52],    # pillow
    [51, 176, 203],    # mirror
    [200, 54, 131],    # floor mat
    [92, 193, 61],     # clothes
    [78, 71, 183],     # ceiling
    [172, 114, 82],    # books
    [255, 127, 14],    # refrigerator
    [91, 163, 138],    # television
    [153, 98, 156],    # paper
    [140, 153, 101],   # towel
    [158, 218, 229],   # shower curtain
    [100, 125, 154],   # box
    [178, 127, 135],   # whiteboard
    [120, 185, 128],   # person
    [146, 111, 194],   # nightstand
    [44, 160, 44],     # toilet
    [112, 128, 144],   # sink
    [96, 207, 209],    # lamp
    [227, 119, 194],   # bathtub
    [213, 92, 176],    # bag
    [94, 106, 211],    # otherstructure
    [82, 84, 163],     # otherfurniture
    [100, 85, 144],    # otherprop
]


def object_color(object_id: int):
    """The palette entry of an object: ``NYU40_COLORS[object_id % 40]``."""
    return tuple(NYU40_COLORS[int(object_id) % len(NYU40_COLORS)])
