"""Entry points: ``serve`` (the GreenServ pool server over real models),
``train`` (the training launcher) and ``mesh`` (the device meshes they and
the elastic re-mesh plan read)."""
