"""The paper's own deployment: early-exit ResNet50/101/152 on CIFAR-100
(paper Sec. IV). FULL configs match the standard bottleneck stage plans;
SMOKE configs shrink width/depth for CPU tests."""

from repro_torch.models.resnet import ResNetConfig

FULL = {
    "resnet50": ResNetConfig(variant="resnet50", num_classes=100),
    "resnet101": ResNetConfig(variant="resnet101", num_classes=100),
    "resnet152": ResNetConfig(variant="resnet152", num_classes=100),
}

SMOKE = {
    "resnet50": ResNetConfig(variant="resnet50", num_classes=100,
                             width_multiplier=0.125,
                             blocks_override=(1, 1, 1, 1)),
    "resnet101": ResNetConfig(variant="resnet101", num_classes=100,
                              width_multiplier=0.125,
                              blocks_override=(1, 1, 2, 1)),
    "resnet152": ResNetConfig(variant="resnet152", num_classes=100,
                              width_multiplier=0.125,
                              blocks_override=(1, 2, 2, 1)),
}
