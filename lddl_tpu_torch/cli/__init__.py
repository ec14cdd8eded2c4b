"""Command-line entry points, run as ``python -m lddl_tpu_torch.cli.<name>``:
``preprocess_bert_pretrain``, ``balance_shards``,
``generate_num_samples_cache`` (counterparts of ``lddl_tpu/cli``)."""
