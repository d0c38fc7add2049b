"""The port's command-line tools, each run with
``python -m scdna_replication_tools_tpu_torch.tools.<name>``:

* ``pert_report``: a run log rendered as markdown, or two runs diffed;
* ``pert_trace``: run logs (and ``profile_dir`` traces) stitched into a
  Perfetto timeline, validated, or a serve spool's latency waterfall;
* ``pert_meter``: the cost and goodput ledgers of a run or a spool;
* ``pert_fleet``: an index of run logs, their trends and the regression
  gate against a baseline;
* ``pert_watch``: run health of a live or finished fit;
* ``chaos_smoke``: a fit killed mid-step and resumed.

The readers are host code and import nothing of JAX: they render the
logs of either package the same way.
"""
