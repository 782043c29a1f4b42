"""Captioning metrics: BLEU-1..4, ROUGE-L, CIDEr-D, METEOR — in-repo.

The reference computes metrics through the external pycocoevalcap repo
(README.md:74-78) and only emits prediction/GT JSON. Here the standard
corpus scorers are first-party so evaluation is one command. Each scorer
follows the pycocoevalcap algorithm exactly:
  * PTB tokenization: Penn-Treebank word splitting (same rule set as the
    Stanford tokenizer pycocoevalcap shells out to, `-preserveLines
    -lowerCase`), then the COCO punctuation-token removal list.
  * BLEU: corpus-level, closest-reference-length brevity penalty with the
    ratio form `exp(1 - 1/ratio)` and the tiny/small (1e-15 / 1e-9)
    robustness constants of the COCO bleu_scorer.
  * ROUGE-L: LCS with max-precision and max-recall taken INDEPENDENTLY
    across references (not max-F), beta=1.2, mean over images.
  * CIDEr-D: tf-idf 1-4grams with candidate-count clipping, length
    gaussian penalty sigma=6, *10 scaling.
  * METEOR: exact+stem matchers by default (Porter stemmer, alpha=0.9,
    beta=3, gamma=0.5 — the classic METEOR formulation), plus OPTIONAL
    synonym and paraphrase matcher stages fed by user-supplied data
    files (`load_synonyms` / `load_paraphrases`; WordNet and the Meteor
    paraphrase tables are external resources this zero-egress repo
    cannot ship). With neither file, scores are typically slightly
    LOWER than the jar METEOR pycocoevalcap shells out to (which always
    has WordNet + paraphrase tables); every score dict therefore
    carries a `METEOR_variant` tag — "exact+stem" through
    "exact+stem+synonym+paraphrase" — so numbers are never silently
    incomparable. SPICE (Java scene-graph parser) is not re-implemented.

Inputs use the COCO format: {image_id: [captions...]} for both candidates
(single-element lists) and references.

The port's own copy of capdec_tpu/eval/metrics.py (no JAX in it).
"""
from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

# ---------------------------------------------------------------------------
# PTB tokenization (Stanford PTBTokenizer behavior for caption-style text)
# ---------------------------------------------------------------------------

# Tokens the COCO evaluation discards after tokenizing (pycocoevalcap
# tokenizer.py PUNCTUATIONS).
PUNCTUATIONS = {"''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
                ".", "?", "!", ",", ":", "-", "--", "...", ";"}

_CONTRACTIONS2 = [
    re.compile(p, re.IGNORECASE) for p in (
        r"\b(can)(not)\b", r"\b(d)('ye)\b", r"\b(gim)(me)\b",
        r"\b(gon)(na)\b", r"\b(got)(ta)\b", r"\b(lem)(me)\b",
        r"\b(more)('n)\b", r"\b(wan)(na)\b")]
_CONTRACTIONS3 = [
    re.compile(p, re.IGNORECASE) for p in (
        r"\b(whad)(dd)(ya)\b", r"\b(wha)(t)(cha)\b")]


def ptb_word_tokenize(text: str) -> List[str]:
    """Penn-Treebank word tokenization (the public sed-script rule set the
    Stanford/NLTK tokenizers implement), specialized to single-line text."""
    t = " " + text + " "
    # starting quotes
    t = re.sub(r"^\s*\"", ' `` ', t)
    t = re.sub(r"(``)", r" \1 ", t)
    t = re.sub(r'([ (\[{<])"', r"\1 `` ", t)
    # punctuation
    t = re.sub(r"([:,])([^\d])", r" \1 \2", t)
    t = re.sub(r"([:,])$", r" \1 ", t)
    t = re.sub(r"\.\.\.", r" ... ", t)
    t = re.sub(r"[;@#$%&]", r" \g<0> ", t)
    # final period (keeps abbreviation dots attached, splits sentence dot)
    t = re.sub(r"([^\.])(\.)([\]\)}>\"']*)\s*$", r"\1 \2\3 ", t)
    t = re.sub(r"[?!]", r" \g<0> ", t)
    t = re.sub(r"([^'])' ", r"\1 ' ", t)
    # brackets -> PTB escapes; square brackets are -LSB-/-RSB- (NOT in the
    # COCO PUNCTUATIONS drop list, so they survive tokenization — matching
    # the Stanford/NLTK tokenizer pycocoevalcap wraps)
    for sym, esc in (("(", "-LRB-"), (")", "-RRB-"), ("[", "-LSB-"),
                     ("]", "-RSB-"), ("{", "-LCB-"), ("}", "-RCB-")):
        t = t.replace(sym, f" {esc} ")
    t = re.sub(r"--", r" -- ", t)
    # ending quotes
    t = re.sub(r'"', " '' ", t)
    t = re.sub(r"(\S)('')", r"\1 \2 ", t)
    # possessives and contractions
    t = re.sub(r"([^' ])('[sS]|'[mM]|'[dD]|') ", r"\1 \2 ", t)
    t = re.sub(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) ", r"\1 \2 ", t)
    for pat in _CONTRACTIONS2:
        t = pat.sub(r" \1 \2 ", t)
    for pat in _CONTRACTIONS3:
        t = pat.sub(r" \1 \2 \3 ", t)
    return t.split()


def ptb_tokenize(caption: str) -> List[str]:
    """COCO-eval tokenization, faithful to the pycocoevalcap chain:
    PTB-tokenize, lowercase the TOKENS (the Stanford jar runs with
    `-lowerCase`, which lowercases output tokens — including the bracket
    escapes), then drop PUNCTUATIONS. Because the escapes come out
    lowercase ('-lrb-') and the PUNCTUATIONS list is uppercase, bracket
    tokens survive — the well-known '-lrb-' artifact in COCO tokenized
    captions."""
    toks = [w.lower() for w in ptb_word_tokenize(caption.strip())]
    return [w for w in toks if w not in PUNCTUATIONS]


def _ensure_tokens(d: Dict) -> Dict:
    """{id: [caption strings]} -> {id: [[tokens]]}; passes through input
    that is already tokenized (lists of token lists). Lets
    `score_predictions` tokenize the corpus ONCE for all four scorers."""
    out = {}
    for k, caps in d.items():
        out[k] = [c if isinstance(c, list) else ptb_tokenize(c)
                  for c in caps]
    return out


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------------------
# BLEU (COCO bleu_scorer semantics)
# ---------------------------------------------------------------------------

_TINY = 1e-15
_SMALL = 1e-9


def bleu(candidates: Dict, references: Dict, max_n: int = 4) -> List[float]:
    """Corpus BLEU-1..max_n with the COCO conventions: closest reference
    length for the brevity penalty (ties -> shorter), the ratio-form BP
    `exp(1 - 1/ratio)`, and (correct+tiny)/(guess+small) precision."""
    candidates = _ensure_tokens(candidates)
    references = _ensure_tokens(references)
    correct = [0] * max_n
    guess = [0] * max_n
    testlen = 0
    reflen = 0
    for img_id, cands in candidates.items():
        cand = cands[0]
        refs = references[img_id]
        if not refs:  # no ground truth for this image: nothing to score
            continue
        testlen += len(cand)
        reflen += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cgrams = _ngrams(cand, n)
            max_ref = Counter()
            for r in refs:
                for g, c in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            correct[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in cgrams.items())
            guess[n - 1] += max(0, len(cand) - n + 1)
    bleus = []
    running = 1.0
    for k in range(max_n):
        running *= (correct[k] + _TINY) / (guess[k] + _SMALL)
        bleus.append(running ** (1.0 / (k + 1)))
    ratio = (testlen + _TINY) / (reflen + _SMALL)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


# ---------------------------------------------------------------------------
# ROUGE-L (COCO rouge.py semantics)
# ---------------------------------------------------------------------------


def _lcs_len(a: List[str], b: List[str]) -> int:
    dp = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        prev = 0
        for j in range(1, len(b) + 1):
            cur = dp[j]
            dp[j] = prev + 1 if a[i - 1] == b[j - 1] else max(dp[j], dp[j - 1])
            prev = cur
    return dp[len(b)]


def rouge_l(candidates: Dict, references: Dict, beta: float = 1.2) -> float:
    """Mean over images of the LCS F-score built from the MAX precision and
    MAX recall taken independently across references (the COCO rouge.py
    formulation — not the max per-reference F-score)."""
    candidates = _ensure_tokens(candidates)
    references = _ensure_tokens(references)
    scores = []
    for img_id, cands in candidates.items():
        cand = cands[0]
        refs = references[img_id]
        if not refs:  # no ground truth: skip, matching bleu()'s convention
            continue
        precs, recs = [], []
        for r in refs:
            lcs = _lcs_len(cand, r)
            precs.append(lcs / len(cand) if cand else 0.0)
            recs.append(lcs / len(r) if r else 0.0)
        prec_max = max(precs)
        rec_max = max(recs)
        if prec_max != 0 and rec_max != 0:
            score = ((1 + beta ** 2) * prec_max * rec_max /
                     (rec_max + beta ** 2 * prec_max))
        else:
            score = 0.0
        scores.append(score)
    return sum(scores) / max(1, len(scores))


# ---------------------------------------------------------------------------
# CIDEr-D (COCO cider_scorer.py semantics)
# ---------------------------------------------------------------------------


def cider_d(candidates: Dict, references: Dict, max_n: int = 4,
            sigma: float = 6.0) -> float:
    candidates = _ensure_tokens(candidates)
    # document frequencies over reference sets
    df: List[Counter] = [Counter() for _ in range(max_n)]
    ref_tokens = _ensure_tokens(references)
    for img_id, toks in ref_tokens.items():
        for n in range(max_n):
            seen = set()
            for r in toks:
                seen.update(_ngrams(r, n + 1).keys())
            for g in seen:
                df[n][g] += 1
    num_imgs = max(1, len(references))
    log_num = math.log(num_imgs)

    def tfidf_vec(tokens: List[str]) -> Tuple[List[Dict], List[float], int]:
        vecs, norms = [], []
        for n in range(max_n):
            grams = _ngrams(tokens, n + 1)
            vec = {}
            norm = 0.0
            for g, c in grams.items():
                idf = log_num - math.log(max(1.0, df[n][g]))
                w = c * idf
                vec[g] = w
                norm += w * w
            vecs.append(vec)
            norms.append(math.sqrt(norm))
        return vecs, norms, len(tokens)

    scores = []
    for img_id, cands in candidates.items():
        refs = ref_tokens[img_id]
        if not refs:  # no ground truth: skip, matching bleu()'s convention
            continue
        c_vec, c_norm, c_len = tfidf_vec(cands[0])
        img_score = 0.0
        for r_toks in refs:
            r_vec, r_norm, r_len = tfidf_vec(r_toks)
            sim_total = 0.0
            for n in range(max_n):
                # CIDEr-D: clip candidate tf-idf at the reference's
                num = sum(min(w, r_vec[n].get(g, 0.0)) * r_vec[n].get(g, 0.0)
                          for g, w in c_vec[n].items())
                if c_norm[n] > 0 and r_norm[n] > 0:
                    sim = num / (c_norm[n] * r_norm[n])
                else:
                    sim = 0.0
                delta = c_len - r_len
                sim *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
                sim_total += sim
            img_score += sim_total / max_n
        scores.append(10.0 * img_score / max(1, len(refs)))
    return sum(scores) / max(1, len(scores))


# ---------------------------------------------------------------------------
# Porter stemmer (from the published algorithm; used by METEOR's stem module)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences in the [C](VC)^m[V] decomposition."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if cons and prev_vowel:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return (len(w) >= 2 and w[-1] == w[-2] and _is_cons(w, len(w) - 1))


def _cvc(w: str) -> bool:
    return (len(w) >= 3 and _is_cons(w, len(w) - 3)
            and not _is_cons(w, len(w) - 2) and _is_cons(w, len(w) - 1)
            and w[-1] not in "wxy")


def porter_stem(word: str) -> str:
    """The Porter (1980) stemming algorithm."""
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ion", "ou", "ism", "ate", "iti",
                "ous", "ive", "ize"):
        if w.endswith(suf):
            stem = w[:-len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and (not stem or stem[-1] not in "st"):
                    break
                w = stem
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


# ---------------------------------------------------------------------------
# METEOR (exact + stem, with an optional synonym matcher stage)
# ---------------------------------------------------------------------------

# word -> frozenset of synset ids; two words are synonym-matched when
# their synset sets intersect (the Meteor jar's wn_synonymy module rule).
SynonymTable = Dict[str, frozenset]


def load_synonyms(path: str) -> SynonymTable:
    """Load a synset file for METEOR's synonym matcher stage.

    Format: plain text, one synset per line, whitespace-separated
    lowercase words; blank lines and `#` comments ignored. A word may
    appear in several synsets (WordNet polysemy). Such a file is easy
    to export from WordNet in environments that have it; this repo is
    zero-egress so none is bundled outside the test fixture
    (tests/fixtures/meteor_synsets.txt)."""
    table: Dict[str, set] = {}
    with open(path) as f:
        for idx, line in enumerate(f):
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            for w in line.lower().split():
                table.setdefault(w, set()).add(idx)
    return {w: frozenset(s) for w, s in table.items()}


# phrase (tuple of words) -> set of equivalent phrases; symmetric closure
# built at load time. Matched on SURFACE tokens, like the Meteor jar's
# paraphrase module (no stemming inside paraphrase entries).
ParaphraseTable = Dict[Tuple[str, ...], set]


def load_paraphrases(path: str, max_phrase_len: int = 6) -> ParaphraseTable:
    """Load a paraphrase table for METEOR's paraphrase matcher stage.

    Format: one pair per line, `phrase1 ||| phrase2` (lowercase,
    whitespace-tokenized phrases); an optional leading numeric field
    (`prob ||| phrase1 ||| phrase2`, the Meteor-1.5 table layout) is
    accepted and ignored. Blank lines and `#` comments are skipped, the
    closure is symmetric, and phrases longer than `max_phrase_len`
    words are dropped (alignment cost guard). Such a file is easy to
    export from the official Meteor paraphrase .gz in environments that
    have it; this zero-egress repo bundles only the test fixture
    (tests/fixtures/meteor_paraphrases.txt)."""
    table: Dict[Tuple[str, ...], set] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            fields = [fd.strip() for fd in line.split("|||")]
            if len(fields) == 3:
                try:
                    float(fields[0])
                    fields = fields[1:]
                except ValueError:
                    pass
            if len(fields) != 2:
                continue
            a = tuple(fields[0].lower().split())
            b = tuple(fields[1].lower().split())
            if (not a or not b or a == b
                    or len(a) > max_phrase_len or len(b) > max_phrase_len):
                continue
            table.setdefault(a, set()).add(b)
            table.setdefault(b, set()).add(a)
    return table


def _meteor_align(cand: List[str], ref: List[str], beam: int = 40,
                  synonyms: SynonymTable = None) -> Tuple[int, int]:
    """Alignment maximizing matches and, among maximal matchings,
    minimizing chunks — the METEOR alignment rule (a greedy assignment
    can inflate the fragmentation penalty; e.g. cand 'a b' vs ref
    'b a b' has a 1-chunk maximal matching a greedy aligner misses).
    Implemented as the same bounded beam search the Meteor aligner uses
    (beam 40). Match predicate: exact token equality, equal Porter
    stems, or — when a synonym table is supplied — a shared synset
    (all count as full matches in the classic scoring).

    Returns (matches, chunks); chunks = maximal runs of consecutive
    candidate positions mapping to consecutive reference positions."""
    stems_r = [porter_stem(r) for r in ref]
    empty = frozenset()
    syn_r = ([(synonyms.get(r, empty)) for r in ref]
             if synonyms else [empty] * len(ref))
    opts: List[List[int]] = []
    for c in cand:
        sc = porter_stem(c)
        syn_c = synonyms.get(c, empty) if synonyms else empty
        opts.append([j for j, r in enumerate(ref)
                     if r == c or stems_r[j] == sc or (syn_c & syn_r[j])])
    # state: (used ref positions, last matched (i, j)) -> fewest chunks;
    # matches == len(used), so the value ordering is chunks alone.
    states: Dict[Tuple[frozenset, Tuple[int, int]], int] = {
        (frozenset(), (-2, -2)): 0}
    for i, options in enumerate(opts):
        new: Dict[Tuple[frozenset, Tuple[int, int]], int] = {}

        def push(key, ch):
            if ch < new.get(key, 1 << 30):
                new[key] = ch

        for (used, last), ch in states.items():
            push((used, last), ch)  # leave candidate word i unmatched
            li, lj = last
            for j in options:
                if j in used:
                    continue
                adjacent = (li == i - 1 and lj == j - 1)
                push((used | {j}, (i, j)), ch + (0 if adjacent else 1))
        # prune to the beam: most matches first, then fewest chunks
        ranked = sorted(new.items(),
                        key=lambda kv: (-len(kv[0][0]), kv[1]))[:beam]
        states = dict(ranked)
    best_m, best_ch = 0, 0
    for (used, _), ch in states.items():
        if (len(used), -ch) > (best_m, -best_ch):
            best_m, best_ch = len(used), ch
    return best_m, best_ch


def _meteor_align_units(cand: List[str], ref: List[str], beam: int = 40,
                        synonyms: SynonymTable = None,
                        paraphrases: ParaphraseTable = None
                        ) -> Tuple[int, int, int]:
    """`_meteor_align` generalized to multi-word match units, enabling
    the paraphrase matcher stage (phrase-pair matches from
    `load_paraphrases`; possibly different lengths on the two sides —
    the Meteor jar's paraphrase module). Word-level units still match
    by exact token, Porter stem, or shared synset; a phrase unit
    occupies contiguous spans on both sides and counts every covered
    word as matched. Returns (matched_cand_words, matched_ref_words,
    chunks); with word-only units the two counts coincide and the
    result equals `_meteor_align` (tested)."""
    stems_r = [porter_stem(r) for r in ref]
    empty = frozenset()
    syn_r = ([(synonyms.get(r, empty)) for r in ref]
             if synonyms else [empty] * len(ref))
    paraphrases = paraphrases or {}
    max_plen = max((len(p) for p in paraphrases), default=1)
    # ref phrase -> start positions, for paraphrase target lookup
    ref_spans: Dict[Tuple[str, ...], List[int]] = {}
    for j in range(len(ref)):
        for lr in range(1, min(max_plen, len(ref) - j) + 1):
            ref_spans.setdefault(tuple(ref[j:j + lr]), []).append(j)
    # units[i] = list of (c_len, r_start, r_len) matches starting at cand i
    units: List[List[Tuple[int, int, int]]] = []
    for i, c in enumerate(cand):
        opts: List[Tuple[int, int, int]] = []
        sc = porter_stem(c)
        syn_c = synonyms.get(c, empty) if synonyms else empty
        for j, r in enumerate(ref):
            if r == c or stems_r[j] == sc or (syn_c & syn_r[j]):
                opts.append((1, j, 1))
        for lc in range(1, min(max_plen, len(cand) - i) + 1):
            for target in paraphrases.get(tuple(cand[i:i + lc]), ()):
                for j in ref_spans.get(target, ()):
                    if (lc, j, len(target)) not in opts:
                        opts.append((lc, j, len(target)))
        units.append(opts)
    # state: (used ref positions, last matched ends (ci, rj), next free
    # cand position) -> (matched cand words, chunks). Ordering: most
    # total matched words first, then fewest chunks (the METEOR rule).
    states: Dict[Tuple[frozenset, Tuple[int, int], int], Tuple[int, int]] = {
        (frozenset(), (-2, -2), 0): (0, 0)}
    for i in range(len(cand)):
        new: Dict[Tuple[frozenset, Tuple[int, int], int],
                  Tuple[int, int]] = {}

        def push(key, mc, ch):
            cur = new.get(key)
            if cur is None or (mc + len(key[0]), -ch) > (
                    cur[0] + len(key[0]), -cur[1]):
                new[key] = (mc, ch)

        for (used, last, free), (mc, ch) in states.items():
            push((used, last, free), mc, ch)  # leave cand word i unmatched
            if i < free:
                continue  # i is inside an already-chosen phrase unit
            li, lj = last
            for (lc, j, lr) in units[i]:
                span = frozenset(range(j, j + lr))
                if span & used:
                    continue
                adjacent = (li == i - 1 and lj == j - 1)
                push((used | span, (i + lc - 1, j + lr - 1), i + lc),
                     mc + lc, ch + (0 if adjacent else 1))
        ranked = sorted(
            new.items(),
            key=lambda kv: (-(kv[1][0] + len(kv[0][0])), kv[1][1]))[:beam]
        states = dict(ranked)
    best = (0, 0, 0)
    for (used, _, _), (mc, ch) in states.items():
        if (mc + len(used), -ch) > (best[0] + best[1], -best[2]):
            best = (mc, len(used), ch)
    return best


def meteor(candidates: Dict, references: Dict, alpha: float = 0.9,
           beta: float = 3.0, gamma: float = 0.5,
           synonyms: SynonymTable = None,
           paraphrases: ParaphraseTable = None) -> float:
    """METEOR with exact+stem matchers, plus the synonym matcher when a
    table from `load_synonyms` is supplied and the paraphrase matcher
    when one from `load_paraphrases` is (see module docstring). Per
    image, the best score over references; corpus score = mean over
    images. With a paraphrase table, precision/recall use the matched
    word counts of each side (phrase pairs may differ in length) and
    fragmentation divides chunks by the mean of the two counts — the
    METEOR generalization; without one this reduces exactly to the
    classic chunks/matches."""
    candidates = _ensure_tokens(candidates)
    references = _ensure_tokens(references)
    scores = []
    for img_id, cands in candidates.items():
        cand = cands[0]
        refs = references[img_id]
        if not refs:  # no ground truth: skip, matching bleu()'s convention
            continue
        best = 0.0
        for ref in refs:
            if not cand or not ref:
                continue
            if paraphrases:
                mc, mr, ch = _meteor_align_units(
                    cand, ref, synonyms=synonyms, paraphrases=paraphrases)
            else:
                mc, ch = _meteor_align(cand, ref, synonyms=synonyms)
                mr = mc
            if mc == 0:
                continue
            p = mc / len(cand)
            r = mr / len(ref)
            fmean = p * r / (alpha * p + (1 - alpha) * r)
            frag = ch / ((mc + mr) / 2)
            penalty = gamma * (frag ** beta)
            best = max(best, fmean * (1 - penalty))
        scores.append(best)
    return sum(scores) / max(1, len(scores))


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def score_predictions(predictions: List[dict], gt_metrics_format: dict,
                      meteor_synonyms: SynonymTable = None,
                      meteor_paraphrases: ParaphraseTable = None) -> Dict:
    """Score prediction JSON [{"caption","image_id"}] against a reference
    `_metrics_format.json` ({"images":[{"id"}],"annotations":[...]}, the
    format emitted by the Karpathy parser — parse_karpathy.py:33-37).

    `meteor_synonyms` / `meteor_paraphrases`: optional tables from
    `load_synonyms` / `load_paraphrases` enabling METEOR's synonym and
    paraphrase matcher stages. The returned dict always carries
    `METEOR_variant` naming the matcher chain that actually ran."""
    refs = defaultdict(list)
    for a in gt_metrics_format["annotations"]:
        refs[int(a["image_id"])].append(a["caption"])
    cands = {}
    for p in predictions:
        img = int(p["image_id"])
        if img in refs and img not in cands:
            cands[img] = [p["caption"]]
    refs = {k: v for k, v in refs.items() if k in cands}
    # tokenize the corpus ONCE; every scorer accepts pre-tokenized input
    cands = _ensure_tokens(cands)
    refs = _ensure_tokens(refs)
    b = bleu(cands, refs)
    return {
        "Bleu_1": b[0], "Bleu_2": b[1], "Bleu_3": b[2], "Bleu_4": b[3],
        "METEOR": meteor(cands, refs, synonyms=meteor_synonyms,
                         paraphrases=meteor_paraphrases),
        "METEOR_variant": ("exact+stem"
                           + ("+synonym" if meteor_synonyms else "")
                           + ("+paraphrase" if meteor_paraphrases else "")),
        "ROUGE_L": rouge_l(cands, refs),
        "CIDEr": cider_d(cands, refs),
        "num_images": float(len(cands)),
    }
