"""The port's model loss and every gradient against the reference's, in
float32, for the families whose training takes more than tokens:
qwen3-moe under the published capacity factor, where pairs are
dropped, llama-3.2-vision with its image embeddings and whisper-base
with its audio frames.  The check and its tolerances are
tests/torch_train_grads.py's, shared with tests/test_torch_train_grads.py."""
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402
from torch_train_grads import \
    model_loss_and_every_grad_match_reference  # noqa: E402

import repro_torch.models.moe as MOE  # noqa: E402

# qwen3-moe-30b-a3b's published capacity factor (the reduced config's is
# a dropless 8.0)
QWEN3_CF = 1.25


def _dropped_pairs(monkeypatch):
    """Record, for each call of the moe dispatch, the (token, choice)
    pairs it drops: those past the capacity C of their expert."""
    drops = []
    real = MOE._dispatch_compute_combine

    def dispatch(xf, w, ids, wg, wu, wd, *, capacity):
        counts = torch.bincount(ids.reshape(-1), minlength=wg.shape[0])
        drops.append(int((counts - capacity).clamp(min=0).sum()))
        return real(xf, w, ids, wg, wu, wd, capacity=capacity)

    monkeypatch.setattr(MOE, "_dispatch_compute_combine", dispatch)
    return drops


@pytest.mark.parametrize("seq, batch", [
    (64, 2),     # capacity C = 40 of 256 pairs over 8 experts: drops
    (1024, 1),   # T >= FLASH_MIN_T: flash's plain path
])
def test_qwen3_moe_grads_match_reference_at_published_capacity(
        monkeypatch, seq, batch):
    """Two moe layers, top-2 of 8 experts, at the published capacity
    factor: the same pairs dropped, the combine in its fixed order and
    the aux loss at TrainConfig.aux_weight, or the loss and the router's
    and experts' gradients would part from the reference's."""
    drops = _dropped_pairs(monkeypatch)
    model_loss_and_every_grad_match_reference(
        "qwen3-moe-30b-a3b", seq, batch, 2, None, None,
        capacity_factor=QWEN3_CF)
    # the forward's two layers (the checkpoints' recomputes follow)
    assert len(drops) >= 2 and sum(drops[:2]) > 0, drops


@pytest.mark.parametrize("seq, batch, layers", [
    # two super-blocks of cross_every 2: each layer's self-attention, a
    # cross-attention after block 0 of each, 8 image tokens of 32
    (16, 2, 4),
    # one super-block at T >= FLASH_MIN_T: flash's plain path in every
    # self-attention, under the super-block's checkpoint
    (1024, 1, 2),
])
def test_llama_vision_grads_match_reference(seq, batch, layers):
    model_loss_and_every_grad_match_reference(
        "llama-3.2-vision-11b", seq, batch, layers, None, None)


def test_whisper_grads_match_reference():
    """2 encoder and 4 decoder layers over 16 frames, each layer under
    its checkpoint: the nested enc / dec groups' every leaf."""
    model_loss_and_every_grad_match_reference(
        "whisper-base", 40, 2, None, None, None)
