"""``parallel.multihost`` held against the JAX package's on the CPU, and
the training steps of a two-process gloo group against the one-process
step on the whole batch.

The file doubles as the child script of the group (no helper file):
``python tests/test_torch_multihost.py RANK PORT OUT`` joins a gloo group
of two processes at ``localhost:PORT``, runs the per-band-gain, SAE and
RVQ steps on its half of the batch over a ``global_mesh(sp=2)`` of two CPU
devices, and writes what they give to ``OUT`` (``save_pytree``). It
imports no JAX. The test spawns the two children once, each with a
timeout, one torch thread each.
"""

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # the child runs as a script
    sys.path.insert(0, ROOT)

from audiocodec_tpu_torch import Codec  # noqa: E402
from audiocodec_tpu_torch.models import rvq  # noqa: E402
from audiocodec_tpu_torch.models import spectral_ae as sae  # noqa: E402
from audiocodec_tpu_torch.parallel import multihost, train  # noqa: E402
from audiocodec_tpu_torch.utils import serialization  # noqa: E402

torch.set_num_threads(1)

SR, N = 16000, 64
CPU = torch.device("cpu")
WORLD = 2
BATCH = 8
CHILD_TIMEOUT_S = 120
AE = sae.SpectralAE(filters_n=N, hidden_n=32, latent_n=8, latent_step=1 / 16)
RVQ_CFG = rvq.RVQ(stages=2, codebook_size=16, dim=8, reseed_threshold=0.5)
LOSS_RTOL, STEP_ATOL = 1e-5, 1e-4  # tests/test_torch_models.py's


def whole_batch():
    x = np.random.default_rng(11).uniform(-0.5, 0.5, (BATCH, 13 * N, 1))
    return torch.from_numpy(x.astype(np.float32))


def run_steps(mesh, x) -> dict:
    """One gains step, two SAE steps with latent noise and three RVQ steps
    (a warm-up step, then reseeds) on ``x`` under ``mesh`` (None: one
    device); the losses, parameters and RVQ state they leave."""
    codec = Codec.create(SR, filters_n=N, bark_bands_n=16, device="cpu")
    out = {}
    state = train.init_state(codec)
    step, _ = train.make_train_step(codec, mesh=mesh)
    out["gains"] = {"loss": step(state, x), "gains": state.gains.detach()}
    params = sae.init_params(torch.Generator().manual_seed(0), AE,
                             device="cpu")
    step, make_opt = sae.make_train_step(codec, AE, mesh=mesh)
    opt = make_opt(list(params.values()))
    gen = torch.Generator().manual_seed(1)
    losses = [step(params, opt, x, gen) for _ in range(2)]
    out["sae"] = {"loss": torch.stack(losses),
                  **{k: v.detach() for k, v in params.items()}}
    params = sae.init_params(torch.Generator().manual_seed(2), AE,
                             device="cpu")
    rstate = rvq.init_state(torch.Generator().manual_seed(3), RVQ_CFG,
                            device="cpu")
    step, make_opt = rvq.make_train_step(codec, AE, RVQ_CFG, mesh=mesh,
                                         warmup_steps=1)
    opt = make_opt(list(params.values()))
    gen = torch.Generator().manual_seed(4)
    losses = [step(params, rstate, opt, x, gen, i) for i in range(3)]
    out["rvq"] = {"loss": torch.stack(losses), **rstate,
                  **{k: v.detach() for k, v in params.items()}}
    return out


def child(rank: int, port: int, path: str) -> None:
    import torch.distributed as dist

    assert multihost.initialize(f"localhost:{port}", WORLD, rank,
                                device="cpu")
    try:
        mesh = multihost.global_mesh(sp=2, devices=[CPU] * 2)
        assert (mesh.rank, mesh.world) == (rank, WORLD)
        local = multihost.process_local_batch(BATCH)
        x = whole_batch()[rank * local:(rank + 1) * local]
        serialization.save_pytree(path, run_steps(mesh, x))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_is_a_noop_on_one_process():
    from audiocodec_tpu.parallel import multihost as jax_multihost

    with mock.patch.dict(os.environ, {"WORLD_SIZE": "1"}):
        assert multihost.initialize() is False
    assert jax_multihost.initialize() is False
    assert not torch.distributed.is_initialized()


def test_process_local_batch_matches_jax():
    from audiocodec_tpu.parallel import multihost as jax_multihost

    assert multihost.process_local_batch(8) == \
        jax_multihost.process_local_batch(8) == 8
    with mock.patch("torch.distributed.is_initialized", return_value=True), \
            mock.patch("torch.distributed.get_world_size", return_value=3):
        assert multihost.process_local_batch(9) == 3
        with pytest.raises(ValueError) as port_err:
            multihost.process_local_batch(8)
    with mock.patch("jax.process_count", return_value=3):
        with pytest.raises(ValueError) as jax_err:
            jax_multihost.process_local_batch(8)
    assert str(port_err.value) == str(jax_err.value)


def test_global_mesh_without_a_group():
    import jax

    from audiocodec_tpu.parallel import multihost as jax_multihost

    mesh = multihost.global_mesh(sp=2, devices=[CPU] * 4)
    assert mesh.shape == {"dp": 2, "sp": 2}
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert jax_multihost.global_mesh(sp=2).shape == {"dp": 4, "sp": 2}
    with pytest.raises(ValueError,
                       match="total devices 4 not divisible by sp=3"):
        multihost.global_mesh(sp=3, devices=[CPU] * 4)
    with pytest.raises(ValueError, match=(
            f"total devices {len(jax.devices())} not divisible by sp=3")):
        jax_multihost.global_mesh(sp=3)


def test_two_process_gloo_steps_equal_one_process(tmp_path):
    """Each rank steps on its half of the batch over dp=1, sp=2 of its own;
    the group's gradients, loss and EMA statistics are averaged or summed
    over gloo, the reseed's picks drawn on rank 0. Both ranks end with the
    same state, that of the one-process step on the whole batch."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(port),
         outs[r]], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * WORLD, logs
    ranks = [serialization.load_pytree(path) for path in outs]
    want = run_steps(None, whole_batch())
    for model, values in want.items():
        for name, v in values.items():
            got = [r[model][name] for r in ranks]
            assert torch.equal(got[0], got[1]), (model, name)
            if name == "loss":
                torch.testing.assert_close(got[0], v, rtol=LOSS_RTOL, atol=0)
            elif name == "ema_count":
                assert torch.equal(got[0], v)
            else:
                torch.testing.assert_close(got[0], v, rtol=0,
                                           atol=STEP_ATOL, msg=f"{model} "
                                           f"{name}")


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
