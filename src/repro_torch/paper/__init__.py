"""The paper's evaluation on the port: Table 3 (offline AUC and cost),
Table 4 (importance weights), Fig 3 (uninstalling CLOES), Fig 4 (user
experience) and Fig 5 (peak load), each a module with the counterpart
of the reference suite's `run()` (benchmarks/*.py) that returns its rows
and the paper's claims as (name, held, detail) triples.

    python -m repro_torch.paper [--scale ci|paper] [--device cuda|cpu]
    python -m repro_torch.paper.table3_offline --scale paper

`--scale ci` is the reference's benchmark log (1,200 queries x 64
items); `--scale paper` is the paper's offline dataset size (61,500 x
64: 1,998,780 instances). Every entry point runs on the CUDA card unless
asked for the CPU."""

# suite name -> its module in this package, in the order they run
MODULES = {"table3": "table3_offline", "table4": "table4_importance",
           "fig3": "fig3_uninstall", "fig4": "fig4_user_experience",
           "fig5": "fig5_peak_load"}
