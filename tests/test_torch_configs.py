"""The port's architecture registry serves every config of the
reference's.

The five configs of the MLA/MoE slice (internlm2-20b and granite-20b,
plain GQA at head width 128; minicpm3-4b, MLA; deepseek-v2-lite-16b,
MLA + MoE; kimi-k2-1t-a32b, GQA + MoE) and the last three
(xlstm-1.3b, mLSTM / sLSTM; whisper-base, the encoder-decoder;
phi-3-vision-4.2b, the vision frontend's stub) are registered and
equal the reference's field for field.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase                     # noqa: E402
from repro_torch.configs import base                        # noqa: E402

NEW = ["internlm2-20b", "granite-20b", "minicpm3-4b", "deepseek-v2-lite-16b",
       "kimi-k2-1t-a32b", "xlstm-1.3b", "whisper-base", "phi-3-vision-4.2b"]


@pytest.mark.parametrize("name", NEW)
def test_slice_configs_are_served_and_equal_the_reference(name):
    assert name in base.list_archs()
    for port, ref in ((base.get_config(name), jbase.get_config(name)),
                      (base.get_smoke(name), jbase.get_smoke(name))):
        for f in dataclasses.fields(port):
            if f.name != "dtype":
                assert getattr(port, f.name) == getattr(ref, f.name), f.name
        assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert (port.batch_axes, port.zero_stage) == (ref.batch_axes,
                                                  ref.zero_stage)
    # what the port leaves out is the reference's switch for counting
    # unrolled layers (it counts a step on the meta device); the mesh
    # fields stay, for the dry run's spec transforms
    ref_only = ({f.name for f in dataclasses.fields(jbase.ArchConfig)}
                - {f.name for f in dataclasses.fields(base.ArchConfig)})
    assert ref_only == {"unroll_layers"}


def test_every_reference_config_is_served_or_refused():
    """The port registers or refuses each of the reference's configs,
    and none is both: all ten are served, none refused."""
    served = set(base.list_archs())
    refused = set(base.UNPORTED)
    assert not served & refused
    assert served | refused == set(jbase.list_archs())
    assert len(served) == 10 and not refused
