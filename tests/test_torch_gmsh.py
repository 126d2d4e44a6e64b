"""The port's GMSH node loader against the JAX package's, on MSH files of
both ASCII formats written into a test directory."""

import numpy as np
import pytest

pytest.importorskip("jax")
pytest.importorskip("torch")

from htool_tpu.testing.gmsh import load_gmsh_nodes as load_jax
from htool_tpu_torch.testing import load_gmsh_nodes as load_torch

MESHES = {
    "v22": ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n"
            "$Nodes\n4\n1 0 0 0\n2 1.5 0 0\n3 0 2.5 1\n4 -1e-3 7 0.25\n$EndNodes\n"
            "$Elements\n1\n1 2 2 0 1 1 2 3\n$EndElements\n"),
    "v41": ("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n"
            "$Nodes\n2 3 1 3\n2 1 0 2\n1\n2\n0 0 0\n1 1 1\n2 2 0 1\n3\n0.5 -2 3e2\n$EndNodes\n"),
}


@pytest.mark.parametrize("fmt", sorted(MESHES))
def test_load_gmsh_nodes(tmp_path, fmt):
    msh = tmp_path / f"{fmt}.msh"
    msh.write_text(MESHES[fmt])
    pts = load_torch(str(msh))
    assert pts.dtype == np.float64 and pts.shape == ((4, 3) if fmt == "v22" else (3, 3))
    np.testing.assert_array_equal(pts, load_jax(str(msh)))
    np.testing.assert_array_equal(pts[-1], [-1e-3, 7, 0.25] if fmt == "v22" else [0.5, -2, 300])


def test_not_a_mesh(tmp_path):
    bad = tmp_path / "x.msh"
    bad.write_text("hello\n")
    with pytest.raises(ValueError, match="not a GMSH ASCII mesh"):
        load_torch(str(bad))
