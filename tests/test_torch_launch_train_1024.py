"""The port's training launcher at its default, reduced configs and
1024 tokens, where every attention layer takes flash (``FLASH_MIN_T``):
on the card its backward is the ``ffma`` pair at the reduced head dims
(16, and MLA's 24 / 16), which once raised there.  On the CPU the plain
versions run; these tests hold the launcher's first step (its loss and
its gradient's global norm) and the losses of ``STEPS`` steps to the
reference's launcher on the reference's weights.

Both launchers build bf16 models over float32 masters, and the two
frameworks round bf16 at other points (XLA keeps float32 between fused
ops).  At global batch 2 the losses of 4 steps part by at most 1.1e-4
(yi-9b) and 5.7e-4 (deepseek-v3) relative, the first gradient's norm by
8.3e-4 and 3.3e-3.  At init the first loss alone tells little: faults
planted in the port move it by 7.0e-4 to 7.2e-3 (no causal mask,
labels unshifted, the MTP labels' roll dropped).  Over 4 steps the
first two move some loss by 1.2e-2 to 3.0e-2, and every fault moves the
first gradient's norm by 2.1e-2 (the MTP roll; no mask at yi-9b) to
0.21 (a CPU run of each fault against the sound port on the same
weights).  So LOSS_RTOL 2e-3 on each step's loss and GNORM_RTOL 1e-2 on
the first gradient's norm hold the sound port with room and each fault
fails one of them.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.launch.train import setup as ref_setup  # noqa: E402
from repro.launch.train import train as ref_train  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402,E501
from repro_torch.launch.train import setup, train  # noqa: E402
from repro_torch.models.convert import from_jax_params  # noqa: E402
from repro_torch.models.layers import FLASH_MIN_T  # noqa: E402

SEQ = 1024
STEPS = 4
LOSS_RTOL = 2e-3
GNORM_RTOL = 1e-2


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v3-671b"])
def test_reduced_launcher_first_step_matches_reference(arch):
    assert SEQ >= FLASH_MIN_T
    ref = ref_setup(arch, reduced=True, seq_len=SEQ, global_batch=2)
    weights = jax.tree.map(np.asarray, ref.params)
    b0 = {k: jnp.asarray(v) for k, v in ref.pipeline.batch_at(0).items()}
    ref.params, ref.opt_state, m = ref.step_fn(ref.params, ref.opt_state, b0)
    want = [float(m["loss"])] + ref_train(ref, STEPS, start_step=1,
                                          verbose=False)["losses"]
    want_norm = float(m["grad_norm"])
    run = setup(arch, reduced=True, seq_len=SEQ, global_batch=2,
                device="cpu")
    run.params = from_jax_params(weights, run.cfg, device="cpu",
                                 compute_dtype=torch.float32)
    before = flash_kernel.flash_attention_bwd_cuda.launches
    b0 = {k: torch.from_numpy(v) for k, v in run.pipeline.batch_at(0).items()}
    run.params, run.opt_state, m = run.step_fn(run.params, run.opt_state, b0)
    got = [float(m["loss"])] + train(run, STEPS, start_step=1,
                                     verbose=False)["losses"]
    assert len(got) == len(want) == STEPS and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), want_norm,
                               rtol=GNORM_RTOL)
    # the CPU path is the plain versions': no kernel counted
    assert flash_kernel.flash_attention_bwd_cuda.launches == before


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launchers_default_to_the_references_arch(launcher):
    """``--arch`` defaults to what the reference's launcher of the same
    name defaults to (serve: deepseek-7b, train: xlstm-125m)."""
    import re
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"

    def default(pkg):
        text = (src / pkg / "launch" / f"{launcher}.py").read_text()
        found = re.findall(r'add_argument\("--arch", default="([^"]+)"\)',
                           text)
        assert len(found) == 1, found
        return found[0]
    assert default("repro_torch") == default("repro")
