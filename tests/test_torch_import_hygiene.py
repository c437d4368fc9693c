"""The port, chip_smoke.py and the mesh tests' rank programs import neither
jax nor the JAX package, and need neither pandas nor sklearn (the GPU
machine has no sklearn)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROG = """
import sys
import node2vec_torch
import node2vec_torch.api, node2vec_torch.convert, node2vec_torch.datasets
import node2vec_torch.embedding, node2vec_torch.eval, node2vec_torch._build
import node2vec_torch.models.skipgram, node2vec_torch.models.word2vec
import node2vec_torch.walk.dense, node2vec_torch.walk.engine, node2vec_torch.ops
import node2vec_torch.walk.blocked, node2vec_torch.walk.csr, node2vec_torch.models.vocab
import node2vec_torch.models.hsoftmax, node2vec_torch.models.cbow, node2vec_torch.native
import node2vec_torch.utils.checkpoint, node2vec_torch.utils.metrics, node2vec_torch.utils
import node2vec_torch.ops.alias, node2vec_torch.models, node2vec_torch.graph.indexer
import node2vec_torch.parallel, node2vec_torch.parallel.launch, node2vec_torch.parallel.mesh
import node2vec_torch.parallel.sharded_walk, node2vec_torch.parallel.sharded_sgns
import node2vec_torch.parallel.rowsharded_sgns, node2vec_torch.parallel.rowsharded_hs
import node2vec_torch.parallel.edge_partitioned_blocked, node2vec_torch.parallel.edge_partitioned
import node2vec_torch.parallel.distributed_build, node2vec_torch.cli
from node2vec_torch.graph import index_graph_pandas  # exported; pandas stays inside it
import chip_smoke
sys.path.insert(0, "tests")
import torch_mesh_ranks, torch_row_ranks, torch_ep_ranks, torch_partition_ranks  # rank programs
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "node2vec_tpu", "pandas", "sklearn"))
assert not bad, bad
print("TORCH_IMPORT_HYGIENE_OK")
"""


def test_port_imports_no_jax_pandas_or_sklearn():
    out = subprocess.run(
        [sys.executable, "-c", PROG], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "TORCH_IMPORT_HYGIENE_OK" in out.stdout


def test_chip_smoke_refuses_without_cuda_or_repo(tmp_path):
    """Alone in a directory, chip_smoke.py fails before printing a result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    out = subprocess.run(
        [sys.executable, str(lone)], capture_output=True, text=True, timeout=120,
        cwd=tmp_path, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
