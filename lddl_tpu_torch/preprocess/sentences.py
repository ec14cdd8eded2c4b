"""Sentence segmentation.

The port's own copy of ``lddl_tpu/preprocess/sentences.py``: the
rule-based splitter (``split_sentences``) and the corpus-learned punkt
decision procedure (``SplitterParams``, ``split_sentences_learned``),
both mirrored by the native engine. Training learned parameters
(``train_splitter_params``) runs nltk's punkt trainer, imported lazily, as
in the reference; the reference's opt-in runtime switch to nltk's own
``sent_tokenize`` is not ported.

The rule-based splitter targets Wikipedia / books / news: split at
[.!?] + closing quotes/brackets + whitespace before anything but a
lowercase letter (lowercase continuations split only after ! / ?, punkt
behavior), with guards for common abbreviations, initials, decimal
numbers and ellipses on '.' boundaries, and punkt-style attachment of
bare list enumerators to the preceding sentence.
"""

import re

_ABBREVIATIONS = frozenset(
    s.lower() for s in (
        "Mr Mrs Ms Dr Prof Sr Jr St Lt Col Gen Rep Sen Gov Capt Cmdr Sgt "
        "Rev Hon Pres Supt Det Insp "
        "vs etc al eg ie cf ca approx "
        "Jan Feb Mar Apr Jun Jul Aug Sep Sept Oct Nov Dec "
        "Mon Tue Wed Thu Fri Sat Sun "
        "No Vol Fig Eq Sec Ch pp ed eds trans "
        "Inc Ltd Corp Co Dept Univ Assn Bros "
        "a.m p.m U.S U.K U.N E.U Ph.D M.D B.A M.A D.C").split())

# A boundary candidate: terminator + optional closing quotes/brackets
# (group 1), whitespace, then anything. What may FOLLOW a boundary is
# decided in code (see split_sentences): everything except a lowercase
# letter — matching punkt, which splits before bullets/quotes/digits —
# and lowercase too when the terminator is ! or ? (unambiguous enders).
_BOUNDARY = re.compile(r"([.!?][\"'\)\]”’]*)\s+(?=\S)")


def _looks_like_abbreviation(left):
    """Is the text left of the boundary an abbreviation / initial / number
    that should NOT end a sentence?"""
    m = re.search(r"(\S+)$", left)
    if not m:
        return False
    word = m.group(1)
    core = word.rstrip(".").strip("\"'()[]“”‘’")
    if not core:
        return False
    # Single capital letter ("J. Smith") or dotted initials ("U.S.").
    if len(core) == 1 and core.isalpha():
        return True
    if re.fullmatch(r"(?:[A-Za-z]\.)+[A-Za-z]?", core):
        return True
    return core.lower() in _ABBREVIATIONS


# A bare list enumerator right after a boundary ("License. 2. Grant ..."):
# punkt glues it to the PRECEDING sentence ("... License. 2.") and splits
# after it, so we suppress the boundary before it and let the enumerator's
# own dot provide the boundary. <= 3 digits so a bare year still starts a
# sentence.
_ENUMERATOR_NEXT = re.compile(r"\d{1,3}\.[\"'\)\]”’]*\s")


class SplitterParams:
    """Corpus-learned punkt parameters driving ``split_sentences_learned``
    (punkt's own unsupervised training, Kiss & Strunk 2006).

    Train once per run on a deterministic corpus sample with
    ``train_splitter_params``; the DECISION procedure then needs no nltk
    and runs at rule-based speed (hash lookups per boundary candidate) —
    mirrored exactly by the C++ engine (fuzz-pinned). Picklable, so pool
    workers receive the same parameters."""

    __slots__ = ("abbrev_types", "collocations", "sent_starters",
                 "ortho_context")

    def __init__(self, abbrev_types=(), collocations=(), sent_starters=(),
                 ortho_context=None):
        self.abbrev_types = frozenset(abbrev_types)
        self.collocations = frozenset(tuple(c) for c in collocations)
        self.sent_starters = frozenset(sent_starters)
        self.ortho_context = dict(ortho_context or {})

    def __reduce__(self):
        return (SplitterParams, (self.abbrev_types, self.collocations,
                                 self.sent_starters, self.ortho_context))

    def serialize(self):
        """Line-oriented UTF-8 blob for the native engine (and for the
        fingerprint): a 'P1' version header, then 'A <abbr>' /
        'C <t1> <t2>' / 'S <starter>' / 'O <type> <flags>' lines, sorted
        for determinism. The header makes even an empty-but-valid params
        object serialize non-empty, so the native engine cannot confuse
        it with "no params = rules splitter"; the C++ parser
        skips unknown tags, so 'P1' needs no native-side handling."""
        lines = ["P1"]
        for a in sorted(self.abbrev_types):
            lines.append("A " + a)
        for t1, t2 in sorted(self.collocations):
            lines.append("C {} {}".format(t1, t2))
        for s in sorted(self.sent_starters):
            lines.append("S " + s)
        for ty, flags in sorted(self.ortho_context.items()):
            if flags:
                lines.append("O {} {}".format(ty, int(flags)))
        return "\n".join(lines).encode("utf-8")


def train_splitter_params(texts, include_all_collocs=True):
    """Unsupervised punkt training (nltk's PunktTrainer — the library is
    the trainer; the decision procedure below is ours and nltk-free) on
    an in-memory corpus sample. Deterministic in the sample. The
    statistics are learned from the corpus itself, which is how punkt's
    pretrained model was built in the first place (Kiss & Strunk
    2006)."""
    from nltk.tokenize.punkt import PunktTrainer
    trainer = PunktTrainer()
    trainer.INCLUDE_ALL_COLLOCS = include_all_collocs
    trainer.train("\n".join(texts), finalize=False)
    p = trainer.get_params()
    return SplitterParams(p.abbrev_types, p.collocations, p.sent_starters,
                          p.ortho_context)


# punkt orthographic-context flags (Kiss & Strunk 2006).
_ORTHO_BEG_UC = 1 << 1
_ORTHO_MID_UC = 1 << 2
_ORTHO_UNK_UC = 1 << 3
_ORTHO_BEG_LC = 1 << 4
_ORTHO_MID_LC = 1 << 5
_ORTHO_UNK_LC = 1 << 6
_ORTHO_UC = _ORTHO_BEG_UC | _ORTHO_MID_UC | _ORTHO_UNK_UC
_ORTHO_LC = _ORTHO_BEG_LC | _ORTHO_MID_LC | _ORTHO_UNK_LC

_NUM_TYPE = re.compile(r"^-?[\.,]?\d[\d,\.-]*\.?$")
_INITIAL = re.compile(r"^[^\W\d]\.$")
_ELLIPSIS = re.compile(r"^\.\.+$")
_PUNCT_TOK = re.compile(r"^[;,:.!?]$")
_WORD_RUN = re.compile(r"\S+")


def _punkt_type(tok):
    """punkt token type: lowercased, numbers collapsed to ##number##."""
    return _NUM_TYPE.sub("##number##", tok.lower())


def _first_case(tok):
    c = tok[:1]
    if c.isupper():
        return "upper"
    if c.islower():
        return "lower"
    return "none"


def _ortho_heuristic(params, tok2, ty2_nosent):
    """punkt 4.1.1: does ``tok2`` look like a sentence start?
    True | False | None (unknown)."""
    if _PUNCT_TOK.match(tok2):
        return False
    ortho = params.ortho_context.get(ty2_nosent, 0)
    case = _first_case(tok2)
    if case == "upper" and (ortho & _ORTHO_LC) \
            and not (ortho & _ORTHO_MID_UC):
        return True
    if case == "lower" and ((ortho & _ORTHO_UC)
                            or not (ortho & _ORTHO_BEG_LC)):
        return False
    return None


def _punkt_boundary(params, w1_tok, w2_tok):
    """Sentence boundary after period-final token ``w1_tok``? The punkt
    first-pass classification + second-pass annotation (4.1.1-4.1.3,
    4.2), decision only — all statistics come from ``params``."""
    ty1 = _punkt_type(w1_tok)
    ty1_nop = ty1[:-1] if ty1.endswith(".") else ty1
    is_ellipsis = bool(_ELLIPSIS.match(w1_tok))
    is_initial = bool(_INITIAL.match(w1_tok))
    abbr = (ty1_nop in params.abbrev_types
            or ("-" in ty1_nop
                and ty1_nop.rsplit("-", 1)[-1] in params.abbrev_types))
    sentbreak = not (abbr or is_ellipsis)  # first pass
    if not w2_tok:
        return sentbreak
    ty2 = _punkt_type(w2_tok)
    ty2_nosent = ty2[:-1] if ty2.endswith(".") else ty2
    if (ty1_nop, ty2_nosent) in params.collocations:     # 4.1.2
        return False
    if (abbr or is_ellipsis) and not is_initial:         # 4.2 + 4.1.1/3
        if _ortho_heuristic(params, w2_tok, ty2_nosent) is True:
            return True
        if _first_case(w2_tok) == "upper" \
                and ty2_nosent in params.sent_starters:
            return True
        return sentbreak
    if is_initial or ty1_nop == "##number##":            # 4.1.1 for these
        oh = _ortho_heuristic(params, w2_tok, ty2_nosent)
        if oh is False:
            return False
        if (oh is None and is_initial
                and _first_case(w2_tok) == "upper"
                and not (params.ortho_context.get(ty2_nosent, 0)
                         & _ORTHO_LC)):
            return False
    return sentbreak


def _punkt_word_before(left):
    """Last word-token of ``left`` the way punkt tokenizes it: closing
    wrappers split off, the terminating period kept on the token."""
    m = re.search(r"(\S+)$", left)
    if not m:
        return ""
    w = m.group(1).rstrip("\"')]}”’*")
    return w if w.endswith(".") else w + "."


def split_sentences_learned(text, params):
    """Split ``text`` with corpus-learned punkt parameters. Same boundary
    CANDIDATES as the rule-based splitter (terminator + closers +
    whitespace); every '.' candidate is decided by the punkt procedure,
    ! and ? always split (punkt sent_end_chars behavior)."""
    sentences = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        if text[m.start(1)] == ".":
            w1 = _punkt_word_before(text[start:m.start(1) + 1])
            nxt = _WORD_RUN.match(text, m.end())
            w2_raw = nxt.group(0) if nxt else ""
            w2 = w2_raw.lstrip("\"'([{“‘*") or w2_raw
            if not _punkt_boundary(params, w1, w2):
                continue
        piece = text[start:m.end(1)].strip()
        if piece:
            sentences.append(piece)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


def split_sentences(text):
    """Split ``text`` into sentences (non-empty, stripped)."""
    sentences = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        terminator = text[m.start(1)]
        nxt = text[m.end()]
        # A sentence may start with anything but a lowercase letter
        # (bullets, quotes, digits, uppercase); lowercase continuations
        # only split after the unambiguous enders ! and ?.
        if nxt.islower() and terminator == ".":
            continue
        if _ENUMERATOR_NEXT.match(text, m.end()):
            continue
        # Left context up to and including the terminator character.
        if terminator == "." and _looks_like_abbreviation(
                text[start:m.start(1) + 1]):
            continue
        piece = text[start:m.end(1)].strip()
        if piece:
            sentences.append(piece)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences
