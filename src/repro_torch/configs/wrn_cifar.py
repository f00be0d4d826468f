"""The paper's own model: WRN-40-1 on CIFAR-10 (Zagoruyko & Komodakis,
arXiv:1605.07146). 3 groups x 6 basic blocks, widen factor 1; split after
group 1 (activation maps 16x32x32) per the paper §4.1 / [18]."""
from dataclasses import dataclass


@dataclass(frozen=True)
class WRNConfig:
    name: str = "wrn-40-1"
    depth: int = 40                # (40-4)/6 = 6 blocks per group
    widen: int = 1
    num_classes: int = 10
    image_size: int = 32
    channels: int = 3
    split_group: int = 1           # paper: split after group 1 -> maps 16x32x32

    @property
    def blocks_per_group(self) -> int:
        assert (self.depth - 4) % 6 == 0
        return (self.depth - 4) // 6

    def reduced(self) -> "WRNConfig":
        return WRNConfig(name="wrn-10-1", depth=10, widen=self.widen,
                         num_classes=self.num_classes, image_size=16,
                         channels=self.channels, split_group=self.split_group)


CONFIG = WRNConfig()
