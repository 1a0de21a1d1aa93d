"""The VGG family (``vgg_a`` = VGG-11, ``vgg_16``, ``vgg_19``).

Counterpart of ``aggregathor_tpu/models/vgg.py`` on NCHW tensors: 3x3
"SAME" conv stacks and 2x2 VALID max-pools (floor sizes), the features
flattened in NHWC order before the dense head, so ``fc1``'s rows line up
with the flax kernel's.  ``fc1``'s input width follows the image size
(flax infers it), so the module takes the input's ``(H, W, C)``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, flatten_nhwc, max_pool, to_nchw

#: name -> convs per stage (the stage filters are 64, 128, 256, 512, 512)
VGG_STAGES = {
    "vgg_a": (1, 1, 2, 2, 2),
    "vgg_16": (2, 2, 3, 3, 3),
    "vgg_19": (2, 2, 4, 4, 4),
}


class VGG(nn.Module):
    def __init__(self, variant="vgg_16", classes=1000, dense_units=4096, shape=(224, 224, 3), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        height, width, cin = shape
        self.stages = []
        for stage, nb_convs in enumerate(VGG_STAGES[variant]):
            filters = min(64 * 2 ** stage, 512)
            names = []
            for conv in range(nb_convs):
                name = "stage%d_conv%d" % (stage + 1, conv)
                setattr(self, name, Conv(cin, filters, 3, dtype=dtype))
                names.append(name)
                cin = filters
            self.stages.append(names)
            height, width = height // 2, width // 2
        self.fc1 = Dense(height * width * cin, dense_units, dtype)
        self.fc2 = Dense(dense_units, dense_units, dtype)
        self.logits = Dense(dense_units, classes)

    def forward(self, x):
        x = to_nchw(x, self.dtype)
        for names in self.stages:
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = max_pool(x, 2, 2)
        x = F.relu(self.fc1(flatten_nhwc(x)))
        x = F.relu(self.fc2(x))
        return self.logits(x)
