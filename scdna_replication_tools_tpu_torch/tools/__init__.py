"""The port's command-line tools: ``pert_watch`` (run health of a live or
finished fit) and ``chaos_smoke`` (kill a fit mid-step and resume it),
each run with ``python -m scdna_replication_tools_tpu_torch.tools.<name>``.
"""
