"""The measurement tools' source variants still apply to the kernels' sources.

Each tool under ``ucod_dpl_tpu_torch/tools`` times edits of a kernel source
(``VARIANTS``: source file, description, edit) on the card; an edit whose
anchor text has left the source fails there only after the build.  Here,
without a card, every edit must find its anchor and change the source.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from ucod_dpl_tpu_torch.tools import attention_ab, int8_ab, lnqkv_ab

CSRC = Path(__file__).resolve().parents[1] / "ucod_dpl_tpu_torch" / "csrc"
CASES = [(mod.__name__.rsplit(".", 1)[1], name, spec)
         for mod in (attention_ab, int8_ab, lnqkv_ab) for name, spec in mod.VARIANTS.items()]


@pytest.mark.parametrize("tool,name,spec", CASES, ids=[f"{t}-{n}" for t, n, _ in CASES])
def test_tool_variant_edit_applies_to_its_source(tool, name, spec):
    source = (CSRC / spec[0]).read_text()
    assert spec[-1](source) != source, f"{tool} variant {name} leaves {spec[0]} unchanged"


def test_int8_ab_variants_name_the_kernels_they_time():
    assert set(int8_ab.VARIANT_KERNELS) == set(int8_ab.VARIANTS)
