"""Multi-rank execution: episode (task) parallelism over PyTorch ranks
(``mesh``), the row-sharded apply with its halo exchange (``spatial``)
and a launcher of local ranks (``launch``)."""
