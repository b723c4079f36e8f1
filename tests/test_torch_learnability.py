"""The learnability golden through the port's CLIs (``data/toy_task.py``
``run_learnability_golden``, the port of ``tests/test_learnability.py``'s
golden): train the simul model on the toy task with the port's ``cli.train``,
then evaluate the untrained and the trained checkpoint streaming, with the
port's ``cli.simuleval --agent s2tt`` for the text and the streaming S2ST
agent for the units, every stage a subprocess on the CPU. The gates are
``tests/test_learnability.py``'s. Marked slow, as that golden is: it takes
minutes, and the tier-1 command leaves it out. ``tools/run_learnability_golden.py``
runs it on the card."""

import numpy as np
import pytest


@pytest.mark.slow
def test_learnability_golden(tmp_path):
    from streamspeech_tpu_torch.data.toy_task import run_learnability_golden

    res = run_learnability_golden(str(tmp_path), max_update=2000, n_train=300, n_dev=24,
                                  device="cpu")
    u, t = res["untrained"], res["trained"]
    assert u["unit_edit_rate"] > 0.6, u
    assert t["unit_edit_rate"] < 0.3, res
    assert t["unit_edit_rate"] < 0.5 * u["unit_edit_rate"], res
    assert t["text_token_acc"] > 0.8, res
    assert t.get("BLEU", 0.0) > 30.0, res
    assert np.isfinite(t.get("AL", np.nan)), res
