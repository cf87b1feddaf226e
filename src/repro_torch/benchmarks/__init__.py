"""The paper-scale harness of the port: the offline replay of the paper's
experiments (``common.run_policy``), the paced ``PoolServer`` drive over
``SimEngine``s (``common.drive_pool_stream``), the closed-loop scenario
drive (``common.run_scenario``, ``run_record``), the baselines table and
closed loop (``baselines.run``, ``run_closed_loop``), the RouterBench
scorecard and closed loop (``routerbench.run_algorithm``,
``run_closed_loop``), GreenCache's workload and drive
(``cache.make_workload``, ``cache.drive``), the scenario lab
(``scenarios``), the chaos drill (``chaos``), disaggregated serving
under bursty traffic (``disagg``), and the paper's remaining experiments:
the λ sweep (``lambda_sweep``, Fig. 4), the feature ablation and the
featurization throughput (``features``, Fig. 5), model addition
(``model_addition``, Fig. 6), the routing overhead (``overhead``, Tables
3–4), steps to the first token against the prefill chunk (``prefill``)
and the energy forecast against the metered ledger (``energy_model``).
It mirrors the JAX package's ``benchmarks/common.py`` and its
``bench_*.py`` of the same names, whose modules import the JAX package
and so cannot serve the port."""
