"""The vocab table of the collates: ``utils.vocab.Vocab``, re-exported
here, beside the loaders that use it. It lives in ``utils`` so the
preprocess's spawned workers, which unpickle it, import no torch."""

from ..utils.vocab import Vocab

__all__ = ["Vocab"]
