"""The SSM and hybrid families trained on a 1x4 mesh (four gloo ranks)
against the reference's one-device step, and every gradient leaf there
(the 1x2, 2x1 and 2x2 meshes are in ``test_torch_mesh_recurrent.py``).

The shared setup and the tests' bodies are in ``_torch_mesh_recurrent.py``."""

from _torch_mesh_recurrent import *  # noqa: F401,F403


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
@pytest.mark.parametrize("shape", MESHES[3:], ids=[f"{d}x{m}" for d, m in MESHES[3:]])
def test_mesh_step_matches_reference(shape, arch):
    """:func:`mesh_step_matches_reference` at 1x4."""
    mesh_step_matches_reference(shape, arch)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS.get)
@pytest.mark.parametrize("shape", [(1, 4)], ids=["1x4"])
def test_every_gradient_leaf(shape, arch):
    """:func:`every_gradient_leaf` at 1x4."""
    every_gradient_leaf(shape, arch)
