"""Entry points: ``serve`` (the GreenServ pool server over real models)."""
