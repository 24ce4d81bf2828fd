"""The sharded train step's numbers for reduced arctic (the MoE router,
B2's input, replicated beside tokens sharded on the batch; the experts
expert-parallel on the model axis) and recurrentgemma (the RG-LRU's gate
weights sharded on the model axis, a local-attention layer), over four
``gloo`` processes on a 2 x 2 mesh: the gates and the checks of
``tests/test_torch_dp_train_gloo.py``.
"""
from test_torch_dp_train_gloo import check_families, one_torch_thread  # noqa: F401

FAMILIES = ("arctic-480b", "recurrentgemma-2b")


def test_sharded_train_steps_of_moe_and_hybrid(tmp_path):
    check_families(FAMILIES, tmp_path)
