"""ResNet-110 / CIFAR-10 — the paper's own experimental workload (§5).
Depth 6n+2 with n=18, non-bottleneck blocks. [He et al. 2016; paper §5]

A copy of ``repro.configs.resnet110``. Like the reference's, the arch
registry (``repro_torch.configs.get_config``) does not list it.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str = "resnet110"
    depth: int = 110                  # 6n+2, n=18
    num_classes: int = 10
    width: int = 16                   # stage widths 16/32/64
    image_size: int = 32
    source: str = "paper §5; arXiv:1603.05027"

    @property
    def n(self) -> int:
        if (self.depth - 2) % 6:
            raise ValueError(f"depth {self.depth} is not 6n+2")
        return (self.depth - 2) // 6


CONFIG = ResNetConfig()


def smoke_config():
    return ResNetConfig(name="resnet8-smoke", depth=8, width=8)
