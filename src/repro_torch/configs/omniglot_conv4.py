"""Paper-faithful Omniglot setup: Conv4 controller, 48-d embeddings,
200-way 10-shot, MTMC CL=32 -> 128K NAND strings (paper Sec. 4.1). Port
of `repro.configs.omniglot_conv4` over this package's SearchConfig and
MCAMConfig."""

from __future__ import annotations

import dataclasses

from repro_torch.core.avss import SearchConfig
from repro_torch.core.mcam import MCAMConfig


@dataclasses.dataclass(frozen=True)
class FSLConfig:
    name: str
    controller: str
    embed_dim: int
    image_size: int
    channels: int
    n_way: int
    k_shot: int
    n_train_classes: int
    n_test_classes: int
    cl: int                      # paper code-word length for the dataset
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)


def get_config() -> FSLConfig:
    return FSLConfig(
        name="omniglot-conv4", controller="conv4", embed_dim=48,
        image_size=28, channels=1, n_way=200, k_shot=10,
        n_train_classes=964, n_test_classes=659, cl=32,
        search=SearchConfig(encoding="mtmc", cl=32, mode="avss",
                            mcam=MCAMConfig()),
    )


def get_smoke_config() -> FSLConfig:
    return FSLConfig(
        name="omniglot-conv4-smoke", controller="conv4", embed_dim=24,
        image_size=20, channels=1, n_way=8, k_shot=3,
        n_train_classes=30, n_test_classes=12, cl=8,
        search=SearchConfig(encoding="mtmc", cl=8, mode="avss",
                            mcam=MCAMConfig()),
    )
