"""Real-text corpora for the language-model families (numpy and Python).

The port's own copy of ``mpi_tensorflow_tpu/data/corpus.py``: the same
tokenizers and masking draws, so one file and one seed give the same
arrays in both packages.

- **byte-level** (default): ids 0-4 are specials (0 pad, 4 the MLM mask
  token, as ``data/synthetic.py``), bytes map to 5..260: vocabulary 261;
- **WordPiece** (``vocab_file=``): a one-token-per-line vocabulary (the
  BERT ``vocab.txt`` layout) with greedy longest-match encoding and
  ``##`` continuation pieces.  The reference takes a C++ encoder for
  ASCII text when its library builds, pinned bit-for-bit to the Python
  one; the port runs the Python one.

``train.mlm_loop`` adopts the loaded vocabulary's size.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

BYTE_VOCAB = 261          # 5 specials + 256 byte values
PAD, MASK_TOKEN = 0, 4
_BYTE_OFFSET = 5


def encode_bytes(text: bytes | str) -> np.ndarray:
    """Byte-level token ids (1-D int32)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.frombuffer(text, np.uint8).astype(np.int32) + _BYTE_OFFSET


def decode_bytes(ids: np.ndarray) -> bytes:
    b = np.asarray(ids, np.int64) - _BYTE_OFFSET
    return b[(b >= 0) & (b < 256)].astype(np.uint8).tobytes()


class WordPieceVocab:
    """BERT-style WordPiece vocabulary + greedy longest-match encoder.

    Vocab file: one token per line (``vocab.txt`` layout); line number is
    the id.  Continuation pieces start with ``##``.  Encoding: lowercase
    (uncased convention), split on whitespace and punctuation, then
    longest-prefix-match within each word; words with no match become
    ``[UNK]``.  Self-contained — no tokenizer package, no downloads.
    """

    def __init__(self, tokens: list):
        self.id_of = {t: i for i, t in enumerate(tokens)}
        self.tokens = list(tokens)
        if len(self.id_of) != len(tokens):
            raise ValueError("vocab file contains duplicate tokens")
        self.unk = self.id_of.get("[UNK]")
        self.mask = self.id_of.get("[MASK]")
        self._max_piece = max((len(t) for t in tokens), default=1)

    @classmethod
    def from_file(cls, path: str) -> "WordPieceVocab":
        # strip() so CRLF-saved vocab files don't leave \r on every token
        # (which would silently match nothing)
        with open(path, encoding="utf-8") as f:
            return cls([line.strip() for line in f if line.strip()])

    def random_replacement_ids(self) -> np.ndarray:
        """Ids eligible as BERT-recipe random replacements: everything
        except bracket-wrapped entries ([PAD], [MASK], [unused57], ...)."""
        ids = np.asarray([i for i, t in enumerate(self.tokens)
                          if not (t.startswith("[") and t.endswith("]"))],
                         np.int32)
        return ids if len(ids) else np.arange(self.size, dtype=np.int32)

    @property
    def size(self) -> int:
        return len(self.tokens)

    def _split_words(self, text: str) -> list:
        out, word = [], []
        for ch in text.lower():
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif not (ch.isalnum() or ch == "'"):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)            # punctuation is its own word
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def encode(self, text: Union[str, bytes]) -> np.ndarray:
        """Greedy longest-match WordPiece ids (1-D int32)."""
        if isinstance(text, bytes):
            text = text.decode("utf-8", errors="replace")
        ids = []
        for word in self._split_words(text):
            pos, pieces = 0, []
            while pos < len(word):
                end = min(len(word), pos + self._max_piece)
                piece_id = None
                while end > pos:
                    cand = word[pos:end]
                    if pos > 0:
                        cand = "##" + cand
                    if cand in self.id_of:
                        piece_id = self.id_of[cand]
                        break
                    end -= 1
                if piece_id is None:      # no match -> whole word is UNK
                    pieces = None
                    break
                pieces.append(piece_id)
                pos = end
            if pieces is None:
                if self.unk is None:
                    raise ValueError(
                        f"word {word!r} has no WordPiece match and the "
                        f"vocab has no [UNK] token to fall back to")
                ids.append(self.unk)
            else:
                ids.extend(pieces)
        return np.asarray(ids, np.int32)


def sequences_from_file(path: str, *, seq_len: int,
                        max_sequences: int | None = None,
                        vocab: Optional[WordPieceVocab] = None) -> np.ndarray:
    """Tokenize a text file into (N, seq_len) int32 rows, the tail
    dropped.  ``vocab``: WordPiece encoding; None = byte-level."""
    with open(path, "rb") as f:
        raw = f.read()
    if vocab is None:
        ids = encode_bytes(raw)
    elif max_sequences is None:
        ids = vocab.encode(raw)
    else:
        # line by line, stopping once enough ids exist (words never
        # span newlines, so this equals encoding the whole file)
        need = max_sequences * seq_len
        parts, total = [], 0
        for line in raw.decode("utf-8", errors="replace").splitlines():
            enc = vocab.encode(line)
            if len(enc):
                parts.append(enc)
                total += len(enc)
            if total >= need:
                break
        ids = (np.concatenate(parts) if parts
               else np.zeros((0,), np.int32))
    n = len(ids) // seq_len
    if max_sequences is not None:
        n = min(n, max_sequences)
    if n == 0:
        raise ValueError(f"{path}: shorter than one sequence ({seq_len})")
    return ids[:n * seq_len].reshape(n, seq_len)


def mlm_from_tokens(tokens: np.ndarray, *, mask_rate: float = 0.15,
                    mask_token: int = MASK_TOKEN, seed: int = 0,
                    random_ids: Optional[np.ndarray] = None):
    """BERT-style masking over a (N, S) token grid.

    80% of selected positions -> mask token, 10% -> random non-special id
    (drawn from ``random_ids``; default the byte range), 10% kept (the
    original BERT recipe); returns ``(inputs, targets, mask)`` in the same
    layout as data/synthetic.mlm_batches.
    """
    rng = np.random.default_rng(seed)
    tokens = np.asarray(tokens, np.int32)
    mask = rng.random(tokens.shape) < mask_rate
    r = rng.random(tokens.shape)
    inputs = tokens.copy()
    inputs[mask & (r < 0.8)] = mask_token
    rand_pos = mask & (r >= 0.8) & (r < 0.9)
    if random_ids is None:
        random_ids = np.arange(_BYTE_OFFSET, BYTE_VOCAB, dtype=np.int32)
    inputs[rand_pos] = rng.choice(np.asarray(random_ids, np.int32),
                                  size=int(rand_pos.sum()))
    return inputs, tokens, mask


def _resolve_vocab(vocab_file) -> Optional[WordPieceVocab]:
    if vocab_file is None:
        return None
    if isinstance(vocab_file, WordPieceVocab):
        return vocab_file
    return WordPieceVocab.from_file(vocab_file)


def load_mlm(path: str, *, seq_len: int = 128, mask_rate: float = 0.15,
             seed: int = 0, max_sequences: int | None = None,
             vocab_file=None):
    """Text file -> masked-LM arrays ``(inputs, targets, mask)``.

    ``vocab_file``: path to a WordPiece vocab (or a ``WordPieceVocab``) —
    masking then uses the vocab's ``[MASK]`` id and draws random
    replacements over its full id range; None = byte-level scheme."""
    vocab = _resolve_vocab(vocab_file)
    toks = sequences_from_file(path, seq_len=seq_len,
                               max_sequences=max_sequences, vocab=vocab)
    if vocab is None:
        return mlm_from_tokens(toks, mask_rate=mask_rate, seed=seed)
    if vocab.mask is None:
        raise ValueError("vocab file has no [MASK] token — required for "
                         "MLM training")
    return mlm_from_tokens(toks, mask_rate=mask_rate, seed=seed,
                           mask_token=vocab.mask,
                           random_ids=vocab.random_replacement_ids())


def load_causal(path: str, *, seq_len: int = 128,
                max_sequences: int | None = None,
                vocab_file=None) -> np.ndarray:
    """Text file -> (N, S) token rows for the causal family (targets are
    the inputs shifted — models/gpt.py derives them)."""
    return sequences_from_file(path, seq_len=seq_len,
                               max_sequences=max_sequences,
                               vocab=_resolve_vocab(vocab_file))
