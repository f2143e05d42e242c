"""Command-line tools of the port, each run as
``python -m selftoktokenizer_tpu_torch.tools.<name>``: ``smoke`` (image ->
ids -> PNG), ``tokenize_corpus`` (a folder or tar shards -> an ids file),
``eval_recon`` (reconstruction quality) and ``encode_corpus`` (VAE latents
of a folder). Each has ``main(argv)``; the loops are functions of their
own, so a caller can drive them without a subprocess."""
