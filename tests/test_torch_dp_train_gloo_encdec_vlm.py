"""The sharded train step's numbers for reduced whisper (the encoder's
frames beside the tokens, cross attention; its key bias's exact gradient
is 0) and llava (image embeddings beside the tokens, the loss on the text
positions only), over four ``gloo`` processes on a 2 x 2 mesh: the gates
and the checks of ``tests/test_torch_dp_train_gloo.py``.
"""
from test_torch_dp_train_gloo import check_families, one_torch_thread  # noqa: F401

FAMILIES = ("whisper-tiny", "llava-next-mistral-7b")


def test_sharded_train_steps_of_encdec_and_vlm(tmp_path):
    check_families(FAMILIES, tmp_path)
