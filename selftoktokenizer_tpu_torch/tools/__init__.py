"""Command-line tools of the port, each run as
``python -m selftoktokenizer_tpu_torch.tools.<name>``: ``smoke`` (image ->
ids -> PNG), ``tokenize_corpus`` (a folder or tar shards -> an ids file;
``merge_token_parts`` joins its ranks' parts), ``eval_recon``
(reconstruction quality) and ``encode_corpus`` (VAE latents of a folder);
the training drivers: ``gen_corpus`` (a synthetic texture corpus),
``train_vae``, ``train_tokenizer`` (its data streams in ``train_data``; its
metrics file read by ``summarize_convergence``), ``train_renderer``,
``convert_ckpt`` (reference files in, the reference-named export out),
``certify_tiers`` (the encode tiers on a trained checkpoint) and
``demo_e2e`` (a trained stack to a PNG grid); and the measurements on the
card: ``measure_k1024`` (the K=1024 encode's rate), ``bench_encode_serving``
(the encode tiers and the encoder stage's forms), ``bench_encoder_bisect``
(the encoder trunk's components), ``bench_flash`` (the attention kernel
against SDPA), ``bench_decode512`` (the 512 px decode and its attention
routes), ``bench_int8`` (int8 against bf16 decode), ``bench_render_overlap``
(three renderer loops), ``bench_train`` (the rematerialised train step),
``bench_scaling`` (the data-parallel encode over ranks), ``bench_loader``
(the image loaders), ``attn_ab`` (the split-TF32 attention source with one
part cut out, timed against it as it is) and ``time_decode`` (warm
flagship decodes). Each has ``main(argv)``; the loops are functions of
their own, so a caller can drive them without a subprocess."""
