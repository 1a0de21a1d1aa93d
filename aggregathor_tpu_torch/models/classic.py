"""Classic small nets: LeNet, CifarNet, AlexNet v2, OverFeat.

Counterpart of ``aggregathor_tpu/models/classic.py`` on NCHW tensors.
LeNet and CifarNet flatten their features in NHWC order before the dense
head (the first dense layer's input width follows the image size, which
flax infers: the modules take the input's ``(H, W, C)``); CifarNet's two
``LayerNorm``s normalise the channel axis only; AlexNet v2 and OverFeat
upsample images below 64 pixels (``resize_min``) and pool globally before
their dense heads.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv, Dense, LayerNorm, flatten_nhwc, global_mean, max_pool, resize_min, to_nchw


class LeNet(nn.Module):
    """2x (conv5x5 + 2x2 max-pool) -> 1024 dense -> logits."""

    def __init__(self, classes=10, shape=(28, 28, 1), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        height, width, cin = shape
        self.conv1 = Conv(cin, 32, 5, dtype=dtype)
        self.conv2 = Conv(32, 64, 5, dtype=dtype)
        self.fc3 = Dense((height // 4) * (width // 4) * 64, 1024, dtype)
        self.logits = Dense(1024, classes)

    def forward(self, x):
        x = to_nchw(x, self.dtype)
        x = max_pool(F.relu(self.conv1(x)), 2, 2)
        x = max_pool(F.relu(self.conv2(x)), 2, 2)
        return self.logits(F.relu(self.fc3(flatten_nhwc(x))))


class CifarNet(nn.Module):
    """2x (conv5x5-64 + 3x3/2 "SAME" pool + LayerNorm) -> 384 -> 192 -> logits."""

    def __init__(self, classes=10, shape=(32, 32, 3), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        height, width, cin = shape
        self.conv1 = Conv(cin, 64, 5, dtype=dtype)
        self.norm1 = LayerNorm(64)
        self.conv2 = Conv(64, 64, 5, dtype=dtype)
        self.norm2 = LayerNorm(64)
        height, width = -(-height // 4), -(-width // 4)  # two "SAME" stride-2 pools
        self.fc3 = Dense(height * width * 64, 384, dtype)
        self.fc4 = Dense(384, 192, dtype)
        self.logits = Dense(192, classes)

    def forward(self, x):
        x = to_nchw(x, self.dtype)
        x = max_pool(F.relu(self.conv1(x)), 3, 2, "SAME")
        x = self.norm1(x)
        x = self.norm2(F.relu(self.conv2(x)))
        x = max_pool(x, 3, 2, "SAME")
        x = F.relu(self.fc3(flatten_nhwc(x)))
        return self.logits(F.relu(self.fc4(x)))


class AlexNetV2(nn.Module):
    """slim alexnet_v2: 5 convs, a global pool for the 6x6 VALID fc, 2 dense."""

    def __init__(self, classes=1000, dense_units=4096, channels=3, dtype=torch.float32, min_size=64):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.conv1 = Conv(channels, 64, 11, 4, dtype=dtype)
        self.conv2 = Conv(64, 192, 5, dtype=dtype)
        self.conv3 = Conv(192, 384, 3, dtype=dtype)
        self.conv4 = Conv(384, 384, 3, dtype=dtype)
        self.conv5 = Conv(384, 256, 3, dtype=dtype)
        self.fc6 = Dense(256, dense_units, dtype)
        self.fc7 = Dense(dense_units, dense_units, dtype)
        self.logits = Dense(dense_units, classes)

    def forward(self, x):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = max_pool(F.relu(self.conv1(x)), 3, 2, "SAME")
        x = max_pool(F.relu(self.conv2(x)), 3, 2, "SAME")
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = max_pool(F.relu(self.conv5(x)), 3, 2, "SAME")
        x = F.relu(self.fc6(global_mean(x)))
        return self.logits(F.relu(self.fc7(x)))


class OverFeat(nn.Module):
    """slim overfeat: 5 convs (11x11/4 stem, a wide 1024 tail), 2 dense."""

    def __init__(self, classes=1000, dense_units=3072, channels=3, dtype=torch.float32, min_size=64):
        super().__init__()
        self.dtype, self.min_size = dtype, min_size
        self.conv1 = Conv(channels, 64, 11, 4, dtype=dtype)
        self.conv2 = Conv(64, 256, 5, dtype=dtype)
        self.conv3 = Conv(256, 512, 3, dtype=dtype)
        self.conv4 = Conv(512, 1024, 3, dtype=dtype)
        self.conv5 = Conv(1024, 1024, 3, dtype=dtype)
        self.fc6 = Dense(1024, dense_units, dtype)
        self.fc7 = Dense(dense_units, dense_units + 1024, dtype)
        self.logits = Dense(dense_units + 1024, classes)

    def forward(self, x):
        x = resize_min(to_nchw(x), self.min_size).to(self.dtype)
        x = max_pool(F.relu(self.conv1(x)), 2, 2, "SAME")
        x = max_pool(F.relu(self.conv2(x)), 2, 2, "SAME")
        x = F.relu(self.conv3(x))
        x = F.relu(self.conv4(x))
        x = max_pool(F.relu(self.conv5(x)), 2, 2, "SAME")
        x = F.relu(self.fc6(global_mean(x)))
        return self.logits(F.relu(self.fc7(x)))
