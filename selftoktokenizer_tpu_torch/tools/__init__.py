"""Command-line tools of the port, each run as
``python -m selftoktokenizer_tpu_torch.tools.<name>``: ``smoke`` (image ->
ids -> PNG), ``tokenize_corpus`` (a folder or tar shards -> an ids file),
``eval_recon`` (reconstruction quality) and ``encode_corpus`` (VAE latents
of a folder); and the training drivers: ``gen_corpus`` (a synthetic
texture corpus), ``train_vae``, ``train_tokenizer`` (its data streams in
``train_data``), ``train_renderer``, ``convert_ckpt`` (reference files in,
the reference-named export out), ``certify_tiers`` (the encode tiers on a
trained checkpoint) and ``demo_e2e`` (a trained stack to a PNG grid); and
two measurements on the card: ``attn_ab`` (the split-TF32 attention source
with one part cut out, timed against it as it is) and ``time_decode``
(warm flagship decodes). Each has ``main(argv)``; the loops are functions of their own, so a caller can
drive them without a subprocess."""
