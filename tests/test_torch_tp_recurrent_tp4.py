"""The recurrent families served at tp 4 (four gloo ranks) under EXACT
against the reference's one-device engine and the one-process engine (tp 2
is in ``test_torch_tp_recurrent.py``).

The shared setup and the test's body are in ``_torch_tp_recurrent.py``."""

from _torch_tp_recurrent import *  # noqa: F401,F403


@pytest.mark.parametrize("arch", ARCHS, ids=["mamba2", "recurrentgemma"])
@pytest.mark.parametrize("tp,policy", CASES[2:], ids=["tp4-exact"])
def test_sharded_recurrent_engine_matches_reference(arch, tp, policy):
    """:func:`sharded_recurrent_engine_matches_reference` at tp 4."""
    sharded_recurrent_engine_matches_reference(arch, tp, policy)
