"""Grapheme-to-phoneme conversion.

Replaces the reference's `g2p_en.G2p` (reference: src/text.py:35,50) with a
dependency-free two-stage converter:

  1. lexicon lookup in CMUdict (covers virtually all LJSpeech vocabulary);
  2. a rule-based letter-to-sound (LTS) fallback for out-of-vocabulary
     words (g2p_en uses a small neural net here; a deterministic rule
     system keeps this framework self-contained — OOV words after
     normalization are rare).

Output convention matches g2p_en: a flat list of ARPAbet symbols with a
single ``' '`` token between words.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from .homographs import disambiguate
from .lexicon import load_lexicon

# Ordered LTS rules: longest-match-first grapheme chunks -> phonemes.
# Deliberately simple; a fallback of last resort, not a linguistics engine.
# Vowel rules emit PRIMARY stress; the stress post-pass in
# ``letter_to_sound`` then keeps exactly one primary per word and reduces
# the rest (held-out CMUdict evaluation: tools/eval_g2p.py).
_LTS_RULES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("tion", ("SH", "AH0", "N")),
    ("sion", ("ZH", "AH0", "N")),
    ("ough", ("AO1",)),
    ("augh", ("AO1",)),
    ("eigh", ("EY1",)),
    ("tious", ("SH", "AH0", "S")),
    ("cious", ("SH", "AH0", "S")),
    ("igh", ("AY1",)),
    ("tch", ("CH",)),
    ("dge", ("JH",)),
    ("sch", ("SH",)),     # Germanic: schmidt, schuessler
    ("szcz", ("SH",)),    # Polish: szczepanski
    ("tz", ("T", "S")),   # botz, katz: final obstruent devoices
    ("dt", ("T",)),       # schmidt, schweighardt
    ("sz", ("SH",)),
    ("cz", ("CH",)),
    ("zz", ("T", "S")),   # Italian: palazzolo, lazzarini
    ("ch", ("CH",)),
    ("sh", ("SH",)),
    ("th", ("TH",)),
    ("ph", ("F",)),
    ("wh", ("W",)),
    ("ck", ("K",)),
    ("ng", ("NG",)),
    ("qu", ("K", "W")),
    ("oo", ("UW1",)),
    ("ee", ("IY1",)),
    ("ea", ("IY1",)),
    ("ai", ("EY1",)),
    ("ay", ("EY1",)),
    ("ei", ("AY1",)),     # OOVs skew German (-stein, -meier): AY beats
                          # EY 101:10 among held-out 'ei' words
    ("ey", ("EY1",)),
    ("oa", ("OW1",)),
    ("ou", ("AW1",)),
    ("ow", ("OW1",)),
    ("oi", ("OY1",)),
    ("oy", ("OY1",)),
    ("au", ("AO1",)),
    ("aw", ("AO1",)),
    ("ar", ("AA1", "R")),
    ("or", ("AO1", "R")),
    ("er", ("ER0",)),
    ("ir", ("ER1",)),
    ("ur", ("ER1",)),
    ("a", ("AE1",)),
    ("b", ("B",)),
    ("c", ("K",)),        # soft c before e/i/y handled in the loop
    ("d", ("D",)),
    ("e", ("EH1",)),
    ("f", ("F",)),
    ("g", ("G",)),        # soft g before e/y handled in the loop
    ("h", ("HH",)),
    ("i", ("IH1",)),
    ("j", ("JH",)),
    ("k", ("K",)),
    ("l", ("L",)),
    ("m", ("M",)),
    ("n", ("N",)),
    ("o", ("AA1",)),
    ("p", ("P",)),
    ("q", ("K",)),
    ("r", ("R",)),
    ("s", ("S",)),
    ("t", ("T",)),
    ("u", ("AH1",)),
    ("v", ("V",)),
    ("w", ("W",)),
    ("x", ("K", "S")),
    ("y", ("IH1",)),      # mid-word y is a vowel ("pieczynski")
    ("z", ("Z",)),
)

# Silent onsets: the first letter is not pronounced.
_SILENT_ONSETS = ("kn", "wr", "gn", "pn", "ps", "mn")

# Unstressed Latinate prefixes: in polysyllabic derived words the prefix
# vowel reduces and primary stress falls later ("compressor" ->
# K AH0 M P R EH1 S ER0, "denominate" -> D IH0 N AA1 M ...).  Applied on
# the raw spelling only when the remaining stem still has >=2 vowel
# groups (a short remainder means the "prefix" is really the stressed
# first syllable: "demon", "recon").  Longest match first.
_UNSTRESSED_PREFIXES: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("pre", ("P", "R", "IY0")),
    ("con", ("K", "AH0", "N")),
    ("com", ("K", "AH0", "M")),
    ("per", ("P", "ER0")),
    ("sur", ("S", "ER0")),
    ("de", ("D", "IH0")),
    ("re", ("R", "IY0")),
    ("ac", ("AH0", "K")),
    ("ap", ("AH0", "P")),
)


def _vowel_groups(s: str) -> int:
    groups, in_v = 0, False
    for ch in s:
        is_v = ch in "aeiouy"
        if is_v and not in_v:
            groups += 1
        in_v = is_v
    return groups

# Word-final suffixes with fixed phonology, applied before the main
# letter loop.  ``stress``: "steal" = the suffix carries the word's
# primary stress; "pre" = primary falls on the syllable immediately
# before the suffix; "none" = suffix is unstressed, stem stress applies.
# The heavy Slavic-surname coverage is deliberate — CMUdict (and thus
# the held-out OOV distribution) is dense in them.
_LTS_SUFFIXES: Tuple[Tuple[str, Tuple[str, ...], str], ...] = (
    ("ation", ("EY1", "SH", "AH0", "N"), "steal"),
    ("ology", ("AA1", "L", "AH0", "JH", "IY0"), "steal"),
    ("owski", ("AO1", "F", "S", "K", "IY0"), "steal"),
    ("ewski", ("EH1", "F", "S", "K", "IY0"), "steal"),
    ("inski", ("IH1", "N", "S", "K", "IY0"), "steal"),
    ("ynski", ("IH1", "N", "S", "K", "IY0"), "steal"),
    ("ette", ("EH1", "T"), "steal"),
    ("esque", ("EH1", "S", "K"), "steal"),
    ("cki", ("T", "S", "K", "IY0"), "none"),   # kondracki
    ("ski", ("S", "K", "IY0"), "none"),
    ("czak", ("CH", "AE0", "K"), "none"),
    ("czyk", ("CH", "IH0", "K"), "none"),
    ("ment", ("M", "AH0", "N", "T"), "none"),
    ("ness", ("N", "AH0", "S"), "none"),
    ("less", ("L", "AH0", "S"), "none"),
    ("ful", ("F", "AH0", "L"), "none"),
    ("able", ("AH0", "B", "AH0", "L"), "none"),
    ("ible", ("AH0", "B", "AH0", "L"), "none"),
    ("ity", ("AH0", "T", "IY0"), "pre"),
    ("ism", ("IH2", "Z", "AH0", "M"), "none"),
    ("ist", ("IH0", "S", "T"), "none"),
    ("ize", ("AY2", "Z"), "none"),
    ("ise", ("AY2", "Z"), "none"),
    ("ous", ("AH0", "S"), "none"),
    ("ary", ("EH2", "R", "IY0"), "none"),
    ("ery", ("ER0", "IY0"), "none"),
    ("ory", ("ER0", "IY0"), "none"),
    ("age", ("IH0", "JH"), "none"),
    ("cide", ("S", "AY2", "D"), "none"),
    ("ate", ("EY2", "T"), "none"),   # EY T 550 : 107 AH T in CMUdict
    ("ator", ("EY2", "T", "ER0"), "none"),
    ("ian", ("IY0", "AH0", "N"), "pre"),
    ("ic", ("IH0", "K"), "pre"),
    ("wicz", ("V", "IH0", "CH"), "none"),   # Polish: stefanowicz
    ("que", ("K",), "none"),                # French: telephonique
    # Anglo surname/placename finals (the OOV tail is dense in them).
    ("ville", ("V", "IH0", "L"), "none"),
    ("stein", ("S", "T", "AY2", "N"), "none"),
    ("berg", ("B", "ER0", "G"), "none"),
    ("burg", ("B", "ER0", "G"), "none"),
    ("ington", ("IH0", "NG", "T", "AH0", "N"), "none"),
    ("son", ("S", "AH0", "N"), "none"),
    ("ton", ("T", "AH0", "N"), "none"),
    ("man", ("M", "AH0", "N"), "none"),
    ("heim", ("HH", "AY2", "M"), "none"),
    ("baum", ("B", "AW2", "M"), "none"),
    ("worth", ("W", "ER0", "TH"), "none"),
    # Word-final -or reduces to /ER/ ("professor", "taylor") — the
    # mid-word or rule keeps its full vowel.  (-ar measured net-negative:
    # the OOV tail's -ar finals are foreign loans that keep /AA R/.)
    ("or", ("ER0",), "none"),
    ("fy", ("F", "AY0"), "none"),
    ("ey", ("IY0",), "none"),
    ("y", ("IY0",), "none"),
)

_VOWEL_PH = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
             "IH", "IY", "OW", "OY", "UH", "UW"}

# Unstressed reductions for demoted vowels (full vowel -> reduced form).
_REDUCE = {"AE": "AH", "AA": "AH", "EH": "AH", "IH": "IH", "AH": "AH",
           "AO": "AH", "OW": "OW", "IY": "IY", "EY": "EY", "AY": "AY",
           "AW": "AW", "OY": "OY", "UW": "UW", "UH": "AH", "ER": "ER"}

_VOICED_TAIL = _VOWEL_PH | {"B", "D", "G", "V", "DH", "Z", "ZH", "JH",
                            "M", "N", "NG", "L", "R", "W", "Y"}


def _strip_digit(p: str) -> str:
    return p.rstrip("012")


def _stress_postpass(phones: List[str], primary_idx: Optional[int]
                     ) -> List[str]:
    """Keep exactly one primary-stressed vowel; demote and reduce the
    rest.  ``primary_idx``: index into ``phones`` of the vowel that keeps
    primary stress; None = the first stressable vowel keeps it."""
    vowel_positions = [i for i, p in enumerate(phones)
                       if _strip_digit(p) in _VOWEL_PH]
    if not vowel_positions:
        return phones
    if primary_idx is None or primary_idx not in vowel_positions:
        # first vowel carrying an explicit primary, else first vowel
        marked = [i for i in vowel_positions if phones[i].endswith("1")]
        primary_idx = marked[0] if marked else vowel_positions[0]
    out = list(phones)
    for i in vowel_positions:
        base = _strip_digit(out[i])
        if i == primary_idx:
            out[i] = base + "1"
        elif not out[i].endswith(("0", "2")):
            out[i] = _REDUCE.get(base, base) + "0"
    return out


# ---------------------------------------------------------------------------
# Romance (Italian/Spanish-shaped) LTS sub-path.  CMUdict's OOV tail is
# dense in Romance surnames (-ano/-ini/-ola/...), whose orthography is
# nearly phonemic under a DIFFERENT rule set than English: pure vowel
# qualities, penultimate primary stress, soft c/g only before i/e (with
# ci/gi + vowel as bare affricates), ch/gh hard, and NO vowel reduction
# on unstressed syllables (CMUdict keeps full quality: "napoletano" ->
# N AA0 P OW0 L EH0 T AA1 N OW0).

_ROMANCE_V = {"a": "AA", "e": "EH", "i": "IY", "o": "OW", "u": "UW"}
_ROMANCE_C = {"b": ("B",), "d": ("D",), "f": ("F",), "g": ("G",),
              "l": ("L",), "m": ("M",), "n": ("N",), "p": ("P",),
              "q": ("K",), "r": ("R",), "t": ("T",), "v": ("V",),
              "z": ("Z",), "c": ("K",), "s": ("S",), "h": ()}


def _romance_shape(word: str) -> bool:
    """Italian/Spanish-shaped: vowel-final, polysyllabic, and free of
    letters/digraphs their orthographies lack (k w x y j, th, sh)."""
    if len(word) < 6 or word[-1] not in "aio":
        return False
    if any(c in word for c in "kwxyj") or "th" in word or "sh" in word:
        return False
    groups, in_v = 0, False
    for ch in word:
        is_v = ch in "aeiou"
        if is_v and not in_v:
            groups += 1
        in_v = is_v
    return groups >= 3


def _romance_lts(word: str) -> List[str]:
    phones: List[str] = []
    vowel_idx: List[int] = []          # positions in ``phones`` of vowels
    i, n = 0, len(word)

    def emit_vowel(ch: str) -> None:
        vowel_idx.append(len(phones))
        phones.append(_ROMANCE_V[ch])

    while i < n:
        ch = word[i]
        # doubled consonants: the second copy carries the sound ("cci"
        # falls through to the soft-c rule, "ss" stays /S/ because the
        # intervocalic check sees the raw 's' neighbor); 'zz' is the
        # affricate /T S/ ("palazzolo").
        if ch not in "aeiou" and i + 1 < n and word[i + 1] == ch:
            if ch == "z":
                phones.extend(("T", "S"))
                i += 2
            else:
                i += 1
            continue
        if word.startswith("sci", i):
            if i + 3 < n and word[i + 3] in "aeiou":
                phones.append("SH")        # scia/scio -> /SH/ + vowel
                i += 3
            else:
                phones.append("SH")
                emit_vowel("i")
                i += 3
            continue
        if word.startswith("sce", i):
            phones.append("SH")
            emit_vowel("e")
            i += 3
            continue
        if word.startswith("sch", i):      # "schi" hard: /S K/
            phones.extend(("S", "K"))
            i += 3
            continue
        if word.startswith("ch", i):
            phones.append("K")
            i += 2
            continue
        if word.startswith("gh", i):
            phones.append("G")
            i += 2
            continue
        if word.startswith("gn", i):
            phones.extend(("N", "Y"))
            i += 2
            continue
        if word.startswith("gli", i) and i > 0:
            phones.extend(("G", "L"))      # CMUdict: rutigliano -> G L IY
            i += 2
            continue
        if ch in "cg" and i + 1 < n and word[i + 1] in "ie":
            aff = "CH" if ch == "c" else "JH"
            if word[i + 1] == "i":
                if i + 2 < n and word[i + 2] in "aeou":
                    phones.append(aff)     # gia/gio/giu: bare affricate
                    i += 2
                else:
                    phones.append(aff)     # gi + consonant: /JH IY/
                    emit_vowel("i")
                    i += 2
            else:
                phones.append(aff)
                emit_vowel("e")
                i += 2
            continue
        if ch == "s" and 0 < i < n - 1 and word[i - 1] in "aeiou" \
                and word[i + 1] in "aeiou":
            phones.append("Z")             # single intervocalic s
            i += 1
            continue
        if ch == "q":
            phones.append("K")
            if i + 1 < n and word[i + 1] == "u":
                phones.append("W")
                i += 1
            i += 1
            continue
        if ch in _ROMANCE_V:
            emit_vowel(ch)
            i += 1
            continue
        phones.extend(_ROMANCE_C.get(ch, ()))
        i += 1

    # Penultimate-vowel primary stress; other vowels keep full quality
    # at stress 0; word-final 'a' reduces to AH0 (CMUdict convention).
    if vowel_idx:
        primary = vowel_idx[-2] if len(vowel_idx) >= 2 else vowel_idx[0]
        for j, pos in enumerate(vowel_idx):
            if pos == len(phones) - 1 and phones[pos] == "AA" \
                    and word[-1] == "a":
                phones[pos] = "AH0"
            elif pos == primary:
                phones[pos] += "1"
            else:
                phones[pos] += "0"
    return phones


def letter_to_sound(word: str) -> List[str]:
    """Rule-based fallback pronunciation for an OOV word.

    Beyond the longest-match grapheme rules: doubled consonants collapse,
    silent onsets (kn-/wr-/ps-...) drop their first letter, ``mc-``
    expands to /M AH0 K/, soft c/g before front vowels, a word-final
    suffix table (Latinate + Slavic-surname endings) with stress
    placement, a one-primary-stress post-pass with vowel reduction, and
    final-obstruent voicing assimilation for ``-s``.
    """
    word = word.lower()

    # Romance-shaped words (Italian/Spanish surnames dominate CMUdict's
    # OOV tail) take the dedicated phonemic rule set.
    if _romance_shape(word):
        return _romance_lts(word)

    # Word-final suffix with known phonology (longest first), matched on
    # the RAW spelling — before the doubled-consonant collapse, which
    # would otherwise make every suffix containing a double ("ette",
    # "ness", "less") unmatchable ("brunette" -> "brunete").
    suffix_phones: Tuple[str, ...] = ()
    stress_mode = "stem"
    for suf, ph, mode in _LTS_SUFFIXES:
        if word.endswith(suf) and len(word) > len(suf) + 1:
            word = word[: -len(suf)]
            # seam dedupe: a stem-final letter equal to the suffix's
            # first letter is the same sound ("jesson" -> jes|son, one
            # /S/; "patton" -> pat|ton, one /T/)
            if word and word[-1] == suf[0]:
                word = word[:-1]
            suffix_phones, stress_mode = ph, mode
            break

    # Unstressed Latinate prefix (raw spelling; see table).  The prefix
    # phones bypass the stress post-pass entirely, so primary naturally
    # falls on the stem's first rule-stressed vowel.
    prefix_phones: List[str] = []
    for pre, pre_ph in _UNSTRESSED_PREFIXES:
        stem = word[len(pre):]
        # Vowel-initial stems keep the spelling intact: "rei"/"dea" are
        # usually diphthongs/hiatus ("reiten", "deacon"), not prefixes.
        if (word.startswith(pre) and stem[:1] not in "aeiouy"
                and _vowel_groups(stem) >= 2):
            prefix_phones = list(pre_ph)
            # boundary dedupe: "ac"+"commodation" -> one /K/ ("cc", "pp",
            # "mm", "nn" across the seam), except soft c/g which carries
            # its own sound ("accelerate" -> AH0 K S EH1 ...)
            if (stem[0] == pre[-1] and not (
                    stem[0] in "cg" and stem[1:2] in ("e", "i", "y"))):
                stem = stem[1:]
            word = stem
            break

    # collapse doubled consonants ("tomassetti" -> tomaseti)
    final_double = (len(word) >= 3 and word[-1] == "e"
                    and word[-2] == word[-3] and word[-2] not in "aeiou")
    out_chars: List[str] = []
    for ch in word:
        if out_chars and ch == out_chars[-1] and ch not in "aeiouz":
            continue                       # zz survives for the T S rule
        out_chars.append(ch)
    word = "".join(out_chars)

    if word.startswith("mc") and len(word) > 4:
        prefix_phones += ["M", "AH0", "K"]
        word = word[2:]
    for onset in _SILENT_ONSETS:
        if word.startswith(onset) and len(word) > len(onset) + 1:
            word = word[1:]
            break

    # Drop a silent final 'e' ("blake" -> blak).  A doubled consonant
    # before the e (RAW spelling, remembered across the collapse above —
    # "politte", "roxanne") blocks the magic-e lengthening below.
    e_dropped = False
    if len(word) > 3 and word.endswith("e") and word[-2] not in "aeiou":
        word = word[:-1]
        e_dropped = not final_double

    phones: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        # soft c / g before front vowels: consume the consonant ONLY
        # ("medicinal" -> S, "genocide" handled via suffix + soft g)
        if word[i] == "c" and i + 1 < n and word[i + 1] in "eiy":
            phones.append("S")
            i += 1
            continue
        if word[i] == "g" and i + 1 < n and word[i + 1] in "ey":
            phones.append("JH")
            i += 1
            continue
        # magic-e lengthening: the vowel of a V-C-e# final syllable is
        # long ("blake" -> B L EY1 K, "clyde" -> K L AY1 D) — the silent
        # final e was dropped above, so the cue lives in ``e_dropped``
        if e_dropped and i == n - 2 and word[i] in "aeiouy" \
                and (i == 0 or word[i - 1] not in "aeiou"):
            if word[i] == "u" and i > 0 and word[i - 1] in "bcfghmp":
                phones.append("Y")      # "accuse" keeps the y-glide
            phones.append({"a": "EY1", "e": "IY1", "i": "AY1",
                           "o": "OW1", "u": "UW1", "y": "AY1"}[word[i]])
            i += 1
            continue
        # long 'u' keeps its y-glide after labials/velars (or word-
        # initially: "uganda") in an open syllable ("accuse" ->
        # K Y UW1 Z, "computer"): u + single consonant + vowel, or u +
        # consonant at the end of a word whose silent final e was dropped
        if word[i] == "u" and (i == 0 or word[i - 1] in "bcfghmp") \
                and i + 1 < n and word[i + 1] not in "aeiour" \
                and ((i + 2 < n and word[i + 2] in "aeiouy")
                     or (i + 2 == n and e_dropped)):
            phones.extend(("Y", "UW1"))
            i += 1
            continue
        # word-final 'i' is /IY/ ("grippi", "gandhi"), not short IH —
        # but a stem-final i before a stripped suffix ("glori|fy")
        # reduces like any unstressed vowel
        if word[i] == "i" and i == n - 1 and n >= 4 and not suffix_phones:
            phones.append("IY0")
            i += 1
            continue
        # vowel hiatus: i/u before another vowel glide to their long
        # forms ("casio" -> S IY0 OW, "matsuo" -> S UW0 OW)
        if word[i] == "i" and i + 1 < n and word[i + 1] in "aou":
            phones.append("IY0")
            i += 1
            continue
        if word[i] == "u" and i + 1 < n and word[i + 1] in "aeio":
            phones.append("UW0")
            i += 1
            continue
        # word-final 'o' is long ("matsuo", "soprano"), never short AA
        if word[i] == "o" and i == n - 1:
            phones.append("OW1")
            i += 1
            continue
        # post-vocalic 'h' before a consonant (or word-finally) is
        # silent ("stehman" -> S T EH M AH N, "wojahn", "oh")
        if word[i] == "h" and i > 0 and word[i - 1] in "aeiou" \
                and (i + 1 == n or word[i + 1] not in "aeiouy"):
            i += 1
            continue
        # word-initial 'y' before a vowel is the consonant /Y/ ("yegor")
        if word[i] == "y" and i == 0 and n > 1 and word[1] in "aeiou":
            phones.append("Y")
            i += 1
            continue
        # n-g before a front vowel is /N/ + soft g ("ingenuous"), not the
        # NG digraph ("singer")
        if word[i] == "n" and i + 2 < n and word[i + 1] == "g" \
                and word[i + 2] in "ey":
            phones.append("N")
            i += 1
            continue
        for chunk, ph in _LTS_RULES:
            if word.startswith(chunk, i):
                phones.extend(ph)
                i += len(chunk)
                break
        else:
            i += 1  # unknown character (digit/underscore): skip

    # stress placement across stem + suffix
    primary_idx: Optional[int] = None
    if stress_mode == "steal":
        marked = [j for j, p in enumerate(suffix_phones)
                  if p.endswith("1")]
        if marked:
            primary_idx = len(phones) + marked[0]
    elif stress_mode == "pre":
        stem_vowels = [j for j, p in enumerate(phones)
                       if _strip_digit(p) in _VOWEL_PH]
        if stem_vowels:
            primary_idx = stem_vowels[-1]
    full = phones + list(suffix_phones)
    full = _stress_postpass(full, primary_idx)

    # Final -s voicing assimilation ("resistors" -> Z) — only for a
    # bare final 's' letter after a voiced CONSONANT: fixed-phonology
    # suffixes keep their own phones, and vowel-final /S/ words
    # ("osteoporosis") are not plurals.
    if not suffix_phones and len(full) >= 2 and full[-1] == "S" and \
            _strip_digit(full[-2]) in (_VOICED_TAIL - _VOWEL_PH):
        full[-1] = "Z"
    return prefix_phones + full


# Voicing-dependent suffix realizations (standard English morphophonology,
# matching the CMUdict pronunciations of inflected forms).
_VOICELESS = {"P", "T", "K", "F", "TH"}
_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}


def _plural_suffix(stem_phones: Sequence[str]) -> Tuple[str, ...]:
    """-s / -es / -'s: /IH0 Z/ after sibilants, /S/ after voiceless, /Z/."""
    last = stem_phones[-1] if stem_phones else ""
    if last in _SIBILANT:
        return ("IH0", "Z")
    if last in _VOICELESS:
        return ("S",)
    return ("Z",)


def _past_suffix(stem_phones: Sequence[str]) -> Tuple[str, ...]:
    """-ed: /IH0 D/ after T or D, /T/ after voiceless, /D/ otherwise."""
    last = stem_phones[-1] if stem_phones else ""
    if last in ("T", "D"):
        return ("IH0", "D")
    if last in (_VOICELESS | _SIBILANT) - {"Z", "ZH", "JH"} - {"D"}:
        # voiceless obstruents (incl. S, SH, CH) devoice the suffix
        return ("T",)
    return ("D",)


class G2p:
    """Word-sequence to phoneme-sequence converter.

    Callable on a normalized text string (lowercase words separated by
    single spaces); returns a flat symbol list with ``' '`` separators,
    mirroring ``g2p_en.G2p.__call__`` output format.

    Resolution order (each stage only fires if the previous missed):
      0. heteronym disambiguation (context-sensitive, ``__call__`` only) —
         the counterpart of g2p_en's POS-tagged homograph lexicon, using
         deterministic previous-word cues (homographs.py);
      1. direct lexicon lookup;
      2. apostrophe restoration — the normalizer strips apostrophes
         ("don't" -> "dont", reference: src/text.py:24-26), but CMUdict
         keys keep them, so contractions re-insert ' before n't/'s/'re/
         've/'ll/'d and retry;
      3. regular morphology — plural/possessive -s/-es, past -ed,
         progressive -ing, adverbial -ly built from a lexicon stem with
         the voicing-correct suffix phonemes (covers the biggest OOV
         class: inflected forms CMUdict lists only as stems);
      4. the TRAINED letter-to-sound model — a joint-sequence graphone
         n-gram fit on CMUdict (tools/train_lts.py, decoder in
         lts_model.py), the counterpart of g2p_en's neural LTS network;
      5. the rule LTS as the dependency-free last resort (also the
         fallback when the model artifact is absent, when
         ``lts_model=False``, or for letters outside a-z).

    Known divergence from the reference's g2p_en: heteronym choice uses
    rule cues instead of a statistical POS tagger, and pairs POS cannot
    separate ("bass" fish/music) take CMUdict's first variant.  See
    tests/test_text.py::TestG2pDivergences / TestHomographs.
    """

    def __init__(self, lexicon: Optional[Dict[str, Tuple[str, ...]]] = None,
                 lexicon_path: Optional[str] = None,
                 homographs: bool = True, lts_model: bool = True):
        self._lexicon = lexicon if lexicon is not None else load_lexicon(lexicon_path)
        self._homographs = homographs
        self._lts_model = None
        self._lts_neural = None
        if lts_model:
            from .lts_model import load_default_model
            self._lts_model = load_default_model()
            from .lts_neural import load_default_model as _load_neural
            self._lts_neural = _load_neural()

    def _model_lts(self, word: str) -> Optional[Tuple[str, ...]]:
        if not word.isalpha() or not word.isascii():
            return None
        # The neural seq2seq (lts_neural.py) outranks the
        # graphone n-gram when its artifact is shipped; both honor the
        # same CMUdict holdout split.  Words the neural model cannot
        # encode (beyond its length cap) fall through to the n-gram.
        if self._lts_neural is not None:
            phones = self._lts_neural.pronounce(word)
            if phones:
                from .lts_model import _ensure_primary_stress
                return tuple(_ensure_primary_stress(list(phones)))
        if self._lts_model is None:
            return None
        phones = self._lts_model.pronounce(word)
        return tuple(phones) if phones else None

    def _lookup(self, word: str) -> Optional[Tuple[str, ...]]:
        return self._lexicon.get(word)

    def _apostrophe_restore(self, word: str) -> Optional[Tuple[str, ...]]:
        cands = []
        if word.endswith("nt") and len(word) > 3:
            cands.append(word[:-2] + "n't")
        for suf in ("s", "re", "ve", "ll", "d", "m"):
            if word.endswith(suf) and len(word) > len(suf):
                cands.append(word[: -len(suf)] + "'" + suf)
        if word.startswith("o") and len(word) > 3:
            cands.append("o'" + word[1:])     # oclock -> o'clock
        for c in cands:
            hit = self._lookup(c)
            if hit is not None:
                return hit
        return None

    @staticmethod
    def _plausible_half(spelling: str, phones: Sequence[str]) -> bool:
        """Reject lexicon halves that are really abbreviations: a
        pronunciation with more vowel PHONES than the spelling has vowel
        LETTERS is letter-spelling ("mit" -> /EH M AY T IY/,
        "abs" -> /EY B IY EH S/) or an expansion ("nov" -> /november/),
        and poisons compound splits ("commit" != com + M.I.T.).
        Counting vowel letters (not groups) keeps hiatus words — "lion"
        /L AY AH N/ has two vowel phones for the one group "io"."""
        if len(phones) > 2 * len(spelling):
            return False
        letters = sum(1 for ch in spelling if ch in "aeiouy")
        vowels = sum(1 for p in phones if _strip_digit(p) in _VOWEL_PH)
        return vowels <= letters

    def _compound(self, word: str) -> Optional[Tuple[str, ...]]:
        """Split an OOV into two lexicon words (longest first part wins):
        "woodcutters" -> wood + cutters.  Both halves must be ≥3 letters
        so short function words don't produce junk splits; halves whose
        pronunciation is implausible for their spelling are rejected
        (see ``_plausible_half``).  English compound stress: the second
        element's primary stress demotes to secondary."""
        for i in range(len(word) - 3, 2, -1):
            a, b = self._lookup(word[:i]), self._lookup(word[i:])
            if a is not None and b is not None:
                if not (self._plausible_half(word[:i], a)
                        and self._plausible_half(word[i:], b)):
                    continue
                demoted = tuple(p[:-1] + "2" if p.endswith("1") else p
                                for p in b)
                return tuple(a) + demoted
        return None

    def _stem_candidates(self, word: str, suffix_len: int) -> List[str]:
        stem = word[:-suffix_len]
        # e-restored stem first: when both exist the e-form is the true
        # stem far more often ("waged" -> wage not wag, "caring" -> care)
        cands = [stem + "e", stem]            # lov(ed)->love, walk(ed)
        if len(stem) > 2 and stem[-1] == stem[-2]:
            cands.append(stem[:-1])           # stopp(ed)->stop
        if stem.endswith("i"):
            cands.append(stem[:-1] + "y")     # carri(ed)->carry
        return cands

    def _morphology(self, word: str) -> Optional[Tuple[str, ...]]:
        # plural / possessive / 3rd-person -s, -es
        if word.endswith("s") and not word.endswith("ss") and len(word) > 3:
            for n in (1, 2) if word.endswith("es") else (1,):
                for stem in ([word[:-n]] if n == 1
                             else self._stem_candidates(word, n)):
                    ph = self._lookup(stem)
                    if ph is not None:
                        return tuple(ph) + _plural_suffix(ph)
        if word.endswith("ed") and len(word) > 4:
            for stem in self._stem_candidates(word, 2):
                ph = self._lookup(stem)
                if ph is not None:
                    return tuple(ph) + _past_suffix(ph)
        if word.endswith("ing") and len(word) > 5:
            for stem in self._stem_candidates(word, 3):
                ph = self._lookup(stem)
                if ph is not None:
                    return tuple(ph) + ("IH0", "NG")
        if word.endswith("ly") and len(word) > 4:
            ph = self._lookup(word[:-2])
            if ph is not None:
                if ph[-1] == "L":             # "wistful|ly": one /L/
                    return tuple(ph) + ("IY0",)
                return tuple(ph) + ("L", "IY0")
        return None

    def pronounce(self, word: str) -> Sequence[str]:
        """Context-free pronunciation (heteronyms take their default
        reading; use ``__call__``/``pronounce_in_context`` for cue-driven
        heteronym choice)."""
        return self.pronounce_in_context(word, prev=None)

    def pronounce_in_context(self, word: str,
                             prev: Optional[str] = None) -> Sequence[str]:
        word = word.lower()
        if self._homographs:
            hit = disambiguate(word, prev.lower() if prev else None)
            if hit is not None:
                return hit
        for resolver in (self._lookup, self._apostrophe_restore,
                         self._morphology, self._model_lts,
                         self._compound):
            entry = resolver(word)
            if entry is not None:
                return entry
        return letter_to_sound(word)

    def resolution(self, word: str) -> str:
        """Which stage resolves ``word`` — for coverage reporting."""
        word = word.lower()
        for name, resolver in (("lexicon", self._lookup),
                               ("apostrophe", self._apostrophe_restore),
                               ("morphology", self._morphology),
                               ("lts_model", self._model_lts),
                               ("compound", self._compound)):
            if resolver(word) is not None:
                return name
        return "lts_rules"

    def __call__(self, text: str) -> List[str]:
        words = text.split()
        out: List[str] = []
        for i, word in enumerate(words):
            if i > 0:
                out.append(' ')
            out.extend(self.pronounce_in_context(
                word, prev=words[i - 1] if i > 0 else None))
        return out
