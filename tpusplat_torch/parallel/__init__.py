"""Tile-sharded rendering and training over ``torch.distributed``
(counterpart of ``tpusplat/parallel/``)."""
