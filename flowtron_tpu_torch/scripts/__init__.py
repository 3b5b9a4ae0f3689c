"""The TPU probes of ``scripts/exp_*.py``, ported: one module per script,
under the same file name, each runnable as

    python -m flowtron_tpu_torch.scripts.<name> [B] [STEPS]

and printing the script's lines (``<variant>: <t> us/step``). Each
module's ``make_inputs`` draws the script's inputs from
``np.random.default_rng(0)`` in the script's order, so the port and the
JAX script compute the same thing on the same numpy arrays. The Pallas
bodies run through the hand-written kernels of ``ops/w4.py`` (P1, P2),
``ops/resident.py`` (P3, P4) and ``ops/fused_cost.py`` (P5); the scripts'
plain XLA baselines stay plain PyTorch (cuBLAS), replayed step by step in
CUDA graphs so host dispatch does not count.

Nothing runs at import: arguments are parsed in ``main(argv=None)``, and
the scripts' module constants are keyword parameters with the scripts'
values as defaults.
"""
