"""Paper-faithful CUB setup: ResNet12 controller, 480-d embeddings,
50-way 5-shot, MTMC CL=25 -> ~125K NAND strings (paper Sec. 4.1). Port
of `repro.configs.cub_resnet12` over this package's FSLConfig,
SearchConfig and MCAMConfig."""

from __future__ import annotations

from repro_torch.configs.omniglot_conv4 import FSLConfig
from repro_torch.core.avss import SearchConfig
from repro_torch.core.mcam import MCAMConfig


def get_config() -> FSLConfig:
    return FSLConfig(
        name="cub-resnet12", controller="resnet12", embed_dim=480,
        image_size=84, channels=3, n_way=50, k_shot=5,
        n_train_classes=100, n_test_classes=50, cl=25,
        search=SearchConfig(encoding="mtmc", cl=25, mode="avss",
                            mcam=MCAMConfig()),
    )


def get_smoke_config() -> FSLConfig:
    return FSLConfig(
        name="cub-resnet12-smoke", controller="resnet12", embed_dim=32,
        image_size=24, channels=3, n_way=6, k_shot=2,
        n_train_classes=20, n_test_classes=8, cl=6,
        search=SearchConfig(encoding="mtmc", cl=6, mode="avss",
                            mcam=MCAMConfig()),
    )
