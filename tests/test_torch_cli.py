"""node2vec_torch's command-line driver (cli.py) against node2vec_tpu's, on
the CPU: stages of the two packages mix on one work directory.

Two chains run side by side in subprocesses on a small random graph:
JAX index -> port walk -> JAX embed -> port eval, and port index -> JAX
walk -> port embed -> JAX eval (the port's stages with ``--device cpu``).
The two indexes write the same ``graph.npz``; on unit weights and p, q
powers of two the two walk stages write the same corpus and parameters;
each package reads the other's model, vectors and parameter files.
"""

import concurrent.futures
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from node2vec_tpu import native as ref_native
from node2vec_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALK = ["--num-walks", "4", "--walk-length", "10", "-p", "0.5", "-q", "2"]
EMBED = ["--dim", "32", "--epochs", "1", "--min-count", "1"]


def _ref_native_loaded(deadline_s: float = 120.0) -> None:
    """Load the JAX package's native library, waiting out a concurrent build
    by another test worker (it compiles in place, and after one failed load
    gives up for the life of the process); fails if it never loads."""
    t_end = time.monotonic() + deadline_s
    while not ref_native.available():
        if time.monotonic() > t_end:
            pytest.fail(f"{ref_native._LIB_PATH} did not load within {deadline_s:.0f} s")
        time.sleep(0.5)


def _run(package: str, stage: str, *args: str) -> str:
    extra = ["--device", "cpu"] if package == "node2vec_torch" and stage != "index" else []
    out = subprocess.run([sys.executable, "-m", f"{package}.cli", stage, *args, *extra],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": ROOT, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, f"{package} {stage}:\n{out.stdout}{out.stderr}"
    return out.stdout


def _chain(edges: str, workdir: str, order) -> dict:
    """index, walk, embed, eval, the stage i by package ``order[i % 2]``;
    returns eval's JSON line."""
    a, b = order
    _run(a, "index", "--input", edges, "--workdir", workdir, "--indexed", "--undirected")
    _run(b, "walk", "--workdir", workdir, *WALK)
    _run(a, "embed", "--workdir", workdir, *EMBED)
    return json.loads(_run(b, "eval", "--workdir", workdir).strip().splitlines()[-1])


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    _ref_native_loaded()  # built before the JAX stages' processes load it
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 300, 2400), rng.integers(0, 300, 2400)
    keep = src != dst
    edges = str(root / "edges.npz")
    np.savez(edges, src=src[keep], dst=dst[keep])
    orders = {"jax_first": ("node2vec_tpu", "node2vec_torch"),
              "port_first": ("node2vec_torch", "node2vec_tpu")}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(_chain, edges, str(root / name), order)
                   for name, order in orders.items()}
        evals = {name: f.result() for name, f in futures.items()}
    return {name: (str(root / name), evals[name]) for name in orders}


def _npz(path: str) -> dict:
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k] for k in z.files}


def test_index_files_equal(chains):
    """Both packages' index stages write the same graph.npz."""
    got = _npz(os.path.join(chains["port_first"][0], "graph.npz"))
    want = _npz(os.path.join(chains["jax_first"][0], "graph.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_walk_files_equal(chains):
    """On the same graph the port's walk stage (on JAX's graph.npz) and
    JAX's (on the port's) write the same corpus and recorded parameters."""
    got = _npz(os.path.join(chains["jax_first"][0], "walks.npz"))
    want = _npz(os.path.join(chains["port_first"][0], "walks.npz"))
    np.testing.assert_array_equal(got["walks"], want["walks"])
    assert json.loads(str(got["n2v_params"])) == json.loads(str(want["n2v_params"]))
    assert got["walks"].shape == (4 * 300, 11) and (got["walks"] >= 0).all()


def test_embed_files_read_by_the_other_package(chains):
    """Each embed stage's model.npz, vectors.txt and w2v_params.json have
    the same keys, shapes and parameters, whichever package wrote them."""
    files = {name: _npz(os.path.join(d, "model.npz")) for name, (d, _) in chains.items()}
    assert sorted(files["jax_first"]) == sorted(files["port_first"])
    for model in files.values():
        assert model["emb_in"].shape == (300, 32) and np.isfinite(model["emb_in"]).all()
    params = []
    for d, _ in chains.values():
        with open(os.path.join(d, "w2v_params.json")) as f:
            params.append(json.load(f))
        with open(os.path.join(d, "vectors.txt")) as f:
            assert f.readline().split() == ["300", "32"]
    assert params[0] == params[1]


@pytest.mark.parametrize("chain", ["jax_first", "port_first"])
def test_eval_reads_the_other_package_files(chains, chain):
    """eval (the port's on JAX's model, JAX's on the port's) prints the
    held-out link AUC."""
    result = chains[chain][1]
    assert result["metric"] == "holdout_link_auc" and result["holdout_frac"] == 0.2
    assert 0.0 <= result["value"] <= 1.0


def test_train_edge_auc_and_labels_in_process(chains, tmp_path, capsys):
    """``eval --train-edge-auc --labels`` in this process on JAX's model:
    the optimistic AUC and the F1 scores of a label file."""
    workdir = chains["jax_first"][0]
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"{v} {v % 3}" for v in range(300)))
    assert cli.main(["eval", "--workdir", workdir, "--train-edge-auc", "--labels", str(labels),
                     "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["metric"] == "train_edge_auc" and 0.0 <= result["value"] <= 1.0
    assert {"micro_f1", "macro_f1"} <= set(result)


def test_device_defaults_to_cuda(chains):
    """The walk stage runs on the card unless told otherwise: without
    ``--device`` it refuses on a machine with no CUDA."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA machine runs the default device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["walk", "--workdir", chains["port_first"][0], "--num-walks", "1"])
