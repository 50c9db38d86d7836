"""The port's README examples run: every ```python block of README.md
that uses `repro_torch`, in order, in one namespace (a later block
builds on an earlier one), on the CPU. tests/test_docs.py runs the JAX
package's blocks and stops at the first that fails, so the port's blocks
after it need this file."""

import pathlib
import re

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _port_blocks() -> list[tuple[int, str]]:
    text = (ROOT / "README.md").read_text()
    blocks = re.findall(r"```python\n(.*?)```", text, re.DOTALL)
    return [(i, b) for i, b in enumerate(blocks) if "repro_torch" in b]


def test_port_readme_blocks_execute():
    """The routed / paged store, the mesh store, the legacy raw-word
    searches, the placed train step and the elastic restore, each
    block's own assertions included."""
    blocks = _port_blocks()
    assert len(blocks) >= 5, [i for i, _ in blocks]
    ns: dict = {}
    for i, block in blocks:
        exec(compile(block, f"README.md[python block {i}]", "exec"), ns)
    assert "back" in ns and "t_legacy" in ns
