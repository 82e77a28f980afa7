"""The demo notebook's twin (examples/demo-contextualsentence-multim_torch.ipynb)
against the JAX notebook: both notebooks' code cells run in this process on
their offline path (no WEIGHTS_DIR, a vocab written from the demo text), the
port's with DEVICE = "cpu".  The port's encoder is given the JAX notebook's
tiny random weights (`models.convert.state_dict_from_flax_params`) after the
cell that builds it; then the token ids are equal, the OT and tsAspire scores
within 1e-4 and the transport plan within 1e-3 of the JAX notebook's, and
both print the same lines."""
import contextlib
import io
import pathlib

import nbformat
import numpy as np
import pytest
import torch

from aspire_tpu_torch.models.convert import state_dict_from_flax_params

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX_NB = REPO / "examples" / "demo-contextualsentence-multim.ipynb"
PORT_NB = REPO / "examples" / "demo-contextualsentence-multim_torch.ipynb"


def code_cells(path) -> list:
    nb = nbformat.read(str(path), as_version=4)
    return [c.source for c in nb.cells if c.cell_type == "code"]


def run_cells(cells, after_encoder=None) -> tuple:
    """Executes the cells in one namespace: (namespace, printed text).
    after_encoder(ns) runs after the cell that builds the encoder."""
    ns, out = {"__name__": "__main__"}, io.StringIO()
    with contextlib.redirect_stdout(out):
        for src in cells:
            exec(compile(src, "<cell>", "exec"), ns)
            if after_encoder is not None and "encoder = ConSentEncoder" in src:
                after_encoder(ns)
    return ns, out.getvalue()


@pytest.fixture(scope="module")
def notebooks():
    jax_ns, jax_out = run_cells(code_cells(JAX_NB))
    port = code_cells(PORT_NB)
    assert 'DEVICE = "cuda"' in port[0]
    port[0] = port[0].replace('DEVICE = "cuda"', 'DEVICE = "cpu"')
    weights = state_dict_from_flax_params(
        jax_ns["params"], jax_ns["cfg"])

    def load(ns):
        ns["encoder"].load_state_dict(weights)

    port_ns, port_out = run_cells(port, load)
    return jax_ns, jax_out, port_ns, port_out


def test_notebook_cells_one_for_one():
    jax_nb = nbformat.read(str(JAX_NB), as_version=4)
    port_nb = nbformat.read(str(PORT_NB), as_version=4)
    assert [c.cell_type for c in port_nb.cells] == [c.cell_type for c in jax_nb.cells]
    assert all(not c.get("outputs") for c in port_nb.cells if c.cell_type == "code")


def test_notebook_tokens_match_jax(notebooks):
    jax_ns, _, port_ns, _ = notebooks
    for field in ("token_ids", "attn_mask", "sent_ids", "abs_lens"):
        np.testing.assert_array_equal(getattr(port_ns["fb"], field),
                                      getattr(jax_ns["fb"], field), err_msg=field)


def test_notebook_scores_and_plan_match_jax(notebooks):
    jax_ns, _, port_ns, _ = notebooks
    assert port_ns["dev"] == torch.device("cpu")
    np.testing.assert_allclose(port_ns["sent_reps"].numpy(),
                               np.asarray(jax_ns["sent_reps"]), atol=1e-5)
    for name in ("sims", "ts"):
        np.testing.assert_allclose(port_ns[name].numpy(), np.asarray(jax_ns[name]),
                                   atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(port_ns["P"], jax_ns["P"], atol=1e-3, rtol=0)


def test_notebook_prints_the_jax_lines(notebooks):
    _, jax_out, _, port_out = notebooks

    def lines(text):
        return [ln.split(":")[0] for ln in text.splitlines()
                if ln.startswith(("CLS reps:", "otAspire", "tsAspire", "plan[",
                                  "  Q:", "  C:"))]

    assert lines(port_out) == lines(jax_out)
    shapes = [ln for ln in port_out.splitlines() if ln.startswith("CLS reps:")]
    assert shapes == [ln for ln in jax_out.splitlines() if ln.startswith("CLS reps:")]
