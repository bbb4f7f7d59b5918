"""The port's distribution layer (port of ``repro.sharding``): partition
specs turned into DTensor placements on a ``DeviceMesh``
(:mod:`.partitioning`) and the current mesh that model code shards its
activations against (:mod:`.context`).  Importing it does not touch CUDA."""
