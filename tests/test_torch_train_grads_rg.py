"""The port's model loss and every gradient against the reference's, in
float32, for the RG-LRU hybrid (recurrentgemma-2b), in a file of its
own: its two cases take about as long as the ten of
tests/test_torch_train_grads.py, whose check and tolerances
(tests/torch_train_grads.py) they share."""
import pytest

jax = pytest.importorskip("jax")
from torch_train_grads import \
    model_loss_and_every_grad_match_reference  # noqa: E402


@pytest.mark.parametrize("arch, seq, batch, layers, vocab, d_head", [
    # the hybrid: two RG-LRU blocks and a local attention layer
    ("recurrentgemma-2b", 16, 2, 3, None, None),
    ("recurrentgemma-2b", 1024, 1, 3, None, None),
])
def test_model_loss_and_every_grad_match_reference(arch, seq, batch, layers,
                                                   vocab, d_head):
    model_loss_and_every_grad_match_reference(arch, seq, batch, layers,
                                              vocab, d_head)
