"""GreenServ in PyTorch: the routing loop and the serving loop on a CUDA
device, with the router's featurize and LinUCB kernels written by hand for
Hopper (``kernels/csrc``).

Mirrors the JAX package's layout (``core/``, ``kernels/<name>/``,
``models/``, ``serving/``, ``data/``, ``configs/``).  Entry points run on
the card unless the caller passes ``device="cpu"``; asking for the card
where there is none raises (``device.resolve_device``).
"""
