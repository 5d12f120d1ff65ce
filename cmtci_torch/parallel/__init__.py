"""Multi-device execution of the port on ``torch.distributed``.

Port of ``cmtci/parallel``. The reference drives N devices from one
controller through ``shard_map`` over a 1-D ``("data",)`` mesh; the port
runs one process per rank instead (SPMD): every rank calls the same
function on the same replicated inputs, computes its block, and gathers or
reduces, so every rank returns the full result.

  * ``sharded`` — the mesh object and the sharded heads and steps;
  * ``launch`` — the rank launcher the CLI and the tests share;
  * ``distributed`` — joining a group started by another launcher
    (``torchrun``, a multi-node job);
  * ``dryrun`` — the multi-rank dry run of the tracker step and the
    analysis heads.
"""
