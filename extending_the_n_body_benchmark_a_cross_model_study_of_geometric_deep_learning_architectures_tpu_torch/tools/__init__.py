"""The research loop's tools: counterparts of the JAX repo's ``scripts/``
of the same names, each run as ``python -m <package>.tools.<name>``.

* :mod:`.pipeline`: the resumable train -> KS-score -> draw-battery loop,
  its stages the port's own ``cli`` in subprocesses, on the card unless
  ``--device`` names another device;
* :mod:`.wait_for_backend`: a bounded wait until the card answers;
* :mod:`.diagnose_macros`: which macro binds a run's combined p;
* :mod:`.archive_row`: a pipeline workdir into a ``docs/results/<row>/``;
* :mod:`.results_report`: the archived rows into
  ``combined_pvalues_summary.csv`` and ``combined_pvalues_multi.png``.

The last three are host tools.  None imports JAX or matplotlib.
"""
