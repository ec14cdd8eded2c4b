"""Corpus downloaders, the pipeline's first stage: raw Wikipedia,
BookCorpus, OpenWebText and Common Crawl news -> one-document-per-line
``<outdir>/source/`` shards. Counterpart of ``lddl_tpu/download/``; each
module runs as ``python -m lddl_tpu_torch.download.<name>``, and each
download or extract step can be skipped with the local-input flags
(``--no-download --no-extract --extracted-dir``, ``--local-archive``,
``--books-dir``, ``--no-newsplease --txt-dir``). No module here imports
torch: the sharding workers are spawned CPU processes."""

from .utils import download, shard_documents

__all__ = ["download", "shard_documents"]
