"""The measurement tools' source variants still apply to the kernels' sources.

Each tool under ``ucod_dpl_tpu_torch/tools`` times edits of a kernel source
(``VARIANTS``: source file, description, edit) on the card; an edit whose
anchor text has left the source fails there only after the build.  Here,
without a card, every edit must find its anchor and change the source, as
the tools build it (``attention_ab.variant_source``: the shared flash-loop
header written into the kernels that include it).  A K1 variant that ports
a TPU prototype by a schedule of its own (a template argument of the
kernel) defines that schedule and launches it from its renamed entry in the
source the tool builds; the main source instantiates no other schedule.
"""

from __future__ import annotations

import re

import pytest

from ucod_dpl_tpu_torch.tools import attention_ab, attn_outproj_ab, int8_ab, lnqkv_ab, patch_embed_ab

CASES = [(mod.__name__.rsplit(".", 1)[1], name, spec)
         for mod in (attention_ab, attn_outproj_ab, int8_ab, lnqkv_ab, patch_embed_ab) for name, spec in mod.VARIANTS.items()]


@pytest.mark.parametrize("tool,name,spec", CASES, ids=[f"{t}-{n}" for t, n, _ in CASES])
def test_tool_variant_edit_applies_to_its_source(tool, name, spec):
    source = attention_ab.variant_source(spec[0])
    assert spec[-1](source) != source, f"{tool} variant {name} leaves {spec[0]} unchanged"


def test_int8_ab_variants_name_the_kernels_they_time():
    assert set(int8_ab.VARIANT_KERNELS) == set(int8_ab.VARIANTS)


@pytest.mark.parametrize("name", sorted(attention_ab.PROTO_VARIANTS))
def test_attention_prototype_variant_launches_its_schedule_from_its_entry(name):
    text = attention_ab.variant_text(name)
    assert f'extern "C" int ucod_attention_fwd_{name}(' in text
    assert re.findall(r"struct (\w+) : Schedule \{", text) == re.findall(r"launch<64, false, bf16, (\w+)>", text)
    main = (attention_ab._build.CSRC / "attention_fwd.cu").read_text()
    assert ": Schedule {" not in main and "launch<64, false, bf16, " not in main
