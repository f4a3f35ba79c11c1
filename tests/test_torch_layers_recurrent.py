"""The recurrent layer types of the port's registry (LSTM, RNN, LSTMUnit)
against JAX (``torch_zoo.run_case``: forward within 1e-5·max(1,|y|),
gradients of inputs and every parameter blob within 1e-4 of each blob's
largest), time-major bottoms, the state reset where cont is 0."""

import numpy as np
import pytest

from torch_zoo import Case, rnd, run_case

T, N, D, H = 4, 3, 5, 6
X = rnd(T, N, D, seed=1)
CONT = np.array([[0, 0, 0], [1, 1, 0], [1, 0, 1], [1, 1, 1]], np.float32)


def rec(t, expose=False, static=False):
    bottoms, inputs = ["x", "cont"], {"x": X, "cont": CONT}
    if static:
        bottoms.append("xs")
        inputs["xs"] = rnd(N, 2, seed=2)
    if expose:
        for i, name in enumerate(["h0", "c0"][: 2 if t == "LSTM" else 1]):
            bottoms.append(name)
            inputs[name] = rnd(1, N, H, seed=3 + i, scale=0.5)
    tops = ["y"] + (["hT", "cT"][: 2 if t == "LSTM" else 1] if expose else [])
    layer = {"name": "l", "type": t, "bottom": bottoms, "top": tops,
             "recurrent_param": {"num_output": H, "expose_hidden": expose,
                                 "weight_filler": {"type": "uniform", "min": -0.3, "max": 0.3}}}
    return Case(f"{t}-expose{expose}-static{static}", [layer], inputs, no_grad=("cont",))


CASES = [
    rec("LSTM"), rec("LSTM", static=True), rec("LSTM", expose=True),
    rec("RNN"), rec("RNN", static=True), rec("RNN", expose=True),
    Case("LSTMUnit", [{"name": "l", "type": "LSTMUnit", "bottom": ["c", "x", "cont"],
                       "top": ["c1", "h1"]}],
         {"c": rnd(1, N, H, seed=4), "x": rnd(1, N, 4 * H, seed=5),
          "cont": np.array([[1, 0, 1]], np.float32)}, no_grad=("cont",)),
]


@pytest.mark.parametrize("case", CASES, ids=[c.id for c in CASES])
def test_recurrent_layer_matches_jax(case):
    run_case(case)
