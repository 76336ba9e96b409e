"""The port's architecture registry refuses what it does not serve, with
the right reason.

granite-20b and internlm2-20b are plain full-attention GQA llama
configs (RoPE, RMSNorm, gated SiLU MLP), every block of which the
port's LM runs; they are only not registered yet.  The reference's
other unregistered architectures need blocks the port lacks.
"""
import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase                     # noqa: E402
from repro_torch.configs import base                        # noqa: E402


@pytest.mark.parametrize("name", ["granite-20b", "internlm2-20b"])
def test_gqa_configs_wait_on_a16_step_1(name):
    with pytest.raises(NotImplementedError) as err:
        base.get_config(name)
    msg = str(err.value)
    assert "A16 step 1" in msg and "GQA" in msg
    for block in ("MLA", "MoE", "xLSTM"):
        assert block not in msg
    ref = jbase.get_config(name)
    assert (ref.attention, ref.norm, ref.gated_mlp) == ("full", "rmsnorm",
                                                       True)
    assert ref.n_kv_heads < ref.n_heads


@pytest.mark.parametrize("name", ["xlstm-1.3b", "deepseek-v2-lite-16b"])
def test_other_unported_configs_keep_their_reason(name):
    with pytest.raises(NotImplementedError, match="MLA, MoE, xLSTM"):
        base.get_config(name)


def test_every_reference_config_is_served_or_refused():
    """The port registers or refuses each of the reference's configs,
    and the two refusal lists do not overlap."""
    served = set(base.list_archs())
    refused = set(base.UNPORTED) | set(base.UNREGISTERED_GQA)
    assert not set(base.UNPORTED) & set(base.UNREGISTERED_GQA)
    assert served | refused == set(jbase.list_archs())
