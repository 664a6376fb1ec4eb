"""hvdlint, hvdrace and the fingerprint verifier of the port
(counterpart of horovod_tpu/analysis/).

* ``hvdlint`` (``python -m horovod_tpu_torch.analysis <paths>``) runs the
  AST rule families over Python source: collective consistency (HVD0xx,
  interprocedural through ``callgraph``), concurrency discipline
  (HVD1xx, including the ``# guarded-by:`` lock annotations) and the
  HVD-ENV documentation rule. ``--format json`` and ``--baseline`` gate
  on new findings only; the port's checked-in baseline,
  ``analysis/hvdlint_baseline.json``, is empty.
* ``race`` (**hvdrace**, ``HOROVOD_RACE_CHECK=1``) enforces the
  ``# guarded-by:`` annotations at run time with an Eraser-style
  lockset detector over the port's annotated runtime classes.
* ``verifier`` (``HOROVOD_CHECK_COLLECTIVES=1``) cross-checks each
  rank's rolling fingerprint of its collectives.
* the analyzers of step programs, ``--hlo`` (**hvdhlo**, HVD2xx,
  ``hlo``/``hlo_rules``), ``--shard`` (**hvdshard**, HVD3xx,
  ``shard``/``shard_rules``), ``--sched`` (**hvdsched**, HVD4xx and the
  comms cost model, ``schedule``/``sched_rules``) and ``--num``
  (**hvdnum**, HVD5xx, ``numerics``/``num_rules``), read one program
  model: lowered StableHLO/HLO text, parsed as the JAX package parses
  it, or a torch step recorded by ``graph`` (the port's counterpart of
  lowering; ``--hlo-step``). Each family has an empty baseline beside
  ``hvdlint_baseline.json``.
"""

from horovod_tpu_torch.analysis.driver import (  # noqa: F401
    Finding, lint_paths, lint_source, main, run_cli,
)
