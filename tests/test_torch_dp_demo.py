"""examples/dp_demo_torch.py (the port's data-parallel demo, two gloo ranks
on the CPU) against the JAX demo's step (examples/dp_demo.py: one jitted
step of gradient descent on a mean squared error) run here on the same
numpy arrays: the five printed losses agree to their four printed
decimals."""

import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "examples", "dp_demo_torch.py")


def test_dp_demo_torch_follows_the_jax_demo():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import dp_demo_torch
    finally:
        sys.path.pop(0)
    out = subprocess.run([sys.executable, DEMO, "--ranks", "2"], capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    got = [float(m) for m in re.findall(r"^step \d loss ([0-9.]+)$", out.stdout, re.M)]
    assert len(got) == dp_demo_torch.STEPS and "data 2 x model 1" in out.stdout

    w, x, y = (jnp.asarray(a) for a in dp_demo_torch.arrays(2))

    @jax.jit
    def step(w, x, y):  # examples/dp_demo.py's step
        def loss_fn(w):
            return jnp.mean((x @ w - y) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(w)
        return w - 0.1 * grads, loss

    want = []
    for _ in range(dp_demo_torch.STEPS):
        w, loss = step(w, x, y)
        want.append(float(loss))
    np.testing.assert_allclose(got, np.round(want, 4), rtol=0, atol=1.5e-4)
    assert got[-1] < got[0]
