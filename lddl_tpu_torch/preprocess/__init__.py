"""The part of the preprocess stage the port owns so far: offline
sequence packing (``packing``) and the Arrow list columns it needs
(``arrowcols``)."""
