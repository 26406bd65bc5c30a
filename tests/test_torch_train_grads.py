"""The port's model loss and every gradient against the reference's, in
float32, for the dense, MoE, MLA and xLSTM families (the check and its
tolerances: tests/torch_train_grads.py; recurrentgemma-2b's cases:
tests/test_torch_train_grads_rg.py).  Inputs and weights come from the
reference's init and numpy with a seed, through both packages."""
import pytest

jax = pytest.importorskip("jax")
from torch_train_grads import \
    model_loss_and_every_grad_match_reference  # noqa: E402


@pytest.mark.parametrize("arch, seq, batch, layers, vocab, d_head", [
    ("yi-9b", 16, 2, 2, None, None),
    ("deepseek-7b", 24, 2, 2, 65536, None),      # the fused head + CE path
    ("yi-9b", 1024, 1, 1, None, None),   # T >= FLASH_MIN_T: flash_attention
    # alternating windows (16 binds at T 1024), softcaps 50 and 30,
    # post-norms; then the heads of 256 the card's backward takes
    ("gemma2-9b", 16, 2, 2, None, None),
    ("gemma2-9b", 1024, 1, 2, None, None),
    ("gemma2-9b", 40, 2, 2, None, 256),
    # deepseek-v3: MLA's naive form at T >= FLASH_MIN_T (flash at Dh 192
    # / Dv 128 on the joined RoPE columns), its leading dense layer, moe
    # layers and MTP head; then the cut the card trains, every layer a
    # leading dense one (layers as (n_layers, dense_layers): an empty
    # main stack) with the MTP head
    ("deepseek-v3-671b", 1024, 1, None, None, None),
    ("deepseek-v3-671b", 40, 2, (2, 2), None, None),
    # xlstm: 2 mLSTM and 2 sLSTM blocks, one chunk and two chunks of 256
    ("xlstm-125m", 40, 2, None, None, None),
    ("xlstm-125m", 512, 1, None, None, None),
])
def test_model_loss_and_every_grad_match_reference(arch, seq, batch, layers,
                                                   vocab, d_head):
    model_loss_and_every_grad_match_reference(arch, seq, batch, layers,
                                              vocab, d_head)
