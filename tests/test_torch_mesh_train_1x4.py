"""Training the dense family on a 1x4 mesh (four gloo ranks): one step
against the reference's one-device step, and an AXQ block that cuts a
shard raising (the 1x2, 2x1 and 2x2 meshes are in
``test_torch_mesh_train.py``).

The shared setup and helpers are in ``_torch_mesh_train.py``."""

from _torch_mesh_train import *  # noqa: F401,F403


def test_axq_block_that_cuts_a_shard_raises():
    """axq8 at block 32 on a 1x4 mesh: wo's K shard (16 rows of 64) is not
    a whole number of the global K's blocks, and the step raises."""
    per, _ = _mesh_run((1, 4))["axq8_block32"]
    assert all("not a whole number of AXQ blocks" in r["raised"] for r in per)


@pytest.mark.parametrize("shape", MESHES[3:], ids=[f"{d}x{m}" for d, m in MESHES[3:]])
def test_mesh_step_matches_reference(shape):
    """:func:`mesh_step_matches_reference` at 1x4."""
    mesh_step_matches_reference(shape)
