"""The paper's figures and tables through the port: one module per figure
or table, each the counterpart of the top-level ``benchmarks/`` module of
the same name (same rows, targets and simulator horizons), run by
``python -m repro_torch.benchmarks.run``. ``jax_rows.json`` holds the JAX
package's own rows, which the port's must equal."""
