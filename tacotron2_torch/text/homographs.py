"""Heteronym (homograph) disambiguation for the G2P frontend.

The reference's `g2p_en` (reference: src/text.py:35) resolves heteronyms —
words whose pronunciation depends on part of speech, like "read" / "use" /
"wind" — with a perceptron POS tagger over a homograph lexicon before
falling back to CMUdict.  This module provides the dependency-free
counterpart: a curated homograph table (every pronunciation is a CMUdict
variant of the word; validated by tests against the vendored lexicon) and
a deterministic context rule in place of the statistical tagger:

  * previous word is an infinitive/modal/auxiliary/subject-pronoun cue
    ("to", "will", "they", "dont", ...)      -> the VERB reading;
  * previous word is a determiner/possessive/preposition cue
    ("the", "his", "of", ...)                -> the NON-VERB reading;
  * otherwise                                -> the word's default reading
    (CMUdict's first variant, except where that variant is clearly the
    rarer reading — e.g. CMUdict lists verb /W AY1 N D/ first for "wind").

Tense heteronyms ("read", "wound") use perfect-auxiliary cues ("have",
"had", ...) to select the past form instead.

This is intentionally not a linguistics engine: it fixes the high-frequency
POS-driven cases a first-variant-only lookup gets wrong, stays fully
deterministic, and degrades to the old behavior when no cue is present.
Semantically ambiguous pairs POS cannot separate (e.g. "bass" fish/music)
are deliberately excluded and remain documented divergences.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

Pron = Tuple[str, ...]


class Homograph(NamedTuple):
    verb: Pron         # reading in verb contexts
    other: Pron        # reading in noun/adjective contexts
    default: str       # "verb" | "other": reading when no context cue fires


def _h(verb: str, other: str, default: str = "other") -> Homograph:
    return Homograph(tuple(verb.split()), tuple(other.split()), default)


# Context cues over the normalized text (lowercase, punctuation stripped,
# apostrophes removed — "don't" arrives as "dont").
_VERB_CUES = frozenset(
    "to will would can could shall should may might must do does did "
    "dont doesnt didnt wont cant cannot couldnt shouldnt wouldnt mustnt "
    "not never i we they you who lets please".split())
_NONVERB_CUES = frozenset(
    "the a an this that these those my your his her its our their whose "
    "any no some each every such another more most very quite of for "
    "with without on in into onto at by from about over under near "
    "after before during against between through toward towards upon".split())
# Perfect-tense cues for the past reading of tense heteronyms.
_PAST_CUES = frozenset(
    "have has had having was were been just already recently".split())


# Every pronunciation below is verbatim a CMUdict variant of its word
# (tests/test_text.py::TestHomographs validates this against the vendored
# lexicon).  ``default`` follows CMUdict's first variant except where
# marked, so the no-cue behavior matches plain first-variant lookup.
HOMOGRAPHS: Dict[str, Homograph] = {
    # vowel-alternating noun/verb pairs
    "lead":      _h("L IY1 D", "L EH1 D"),
    "live":      _h("L IH1 V", "L AY1 V"),
    "lives":     _h("L IH1 V Z", "L AY1 V Z", default="verb"),
    "wind":      _h("W AY1 N D", "W IH1 N D"),          # default overridden:
    #   CMUdict lists the verb first, but the noun dominates usage
    "tear":      _h("T EH1 R", "T IH1 R", default="verb"),
    "tears":     _h("T EH1 R Z", "T IH1 R Z", default="verb"),
    "bow":       _h("B AW1", "B OW1", default="verb"),
    "bows":      _h("B AW1 Z", "B OW1 Z", default="verb"),
    # voicing pairs (verb /z/, noun /s/)
    "close":     _h("K L OW1 Z", "K L OW1 S"),
    "use":       _h("Y UW1 Z", "Y UW1 S"),
    "uses":      _h("Y UW1 Z AH0 Z", "Y UW1 S AH0 Z"),
    "excuse":    _h("IH0 K S K Y UW1 Z", "IH0 K S K Y UW1 S"),
    "abuse":     _h("AH0 B Y UW1 Z", "AH0 B Y UW1 S"),
    "refuse":    _h("R AH0 F Y UW1 Z", "R EH1 F Y UW2 Z", default="verb"),
    # stress-shift noun/verb pairs
    "record":    _h("R AH0 K AO1 R D", "R EH1 K ER0 D"),
    "records":   _h("R AH0 K AO1 R D Z", "R EH1 K ER0 D Z"),
    #   record/records default overridden: CMUdict lists the verb
    #   /R AH0 K AO1 R D/ first, but the noun dominates usage
    "present":   _h("P R IY0 Z EH1 N T", "P R EH1 Z AH0 N T"),
    "presents":  _h("P R IY0 Z EH1 N T S", "P R EH1 Z AH0 N T S"),
    "produce":   _h("P R AH0 D UW1 S", "P R OW1 D UW0 S", default="verb"),
    "project":   _h("P R AH0 JH EH1 K T", "P R AA1 JH EH0 K T"),
    "progress":  _h("P R AH0 G R EH1 S", "P R AA1 G R EH2 S"),
    "object":    _h("AH0 B JH EH1 K T", "AA1 B JH EH0 K T"),
    "objects":   _h("AH0 B JH EH1 K T S", "AA1 B JH EH0 K T S"),
    "subject":   _h("S AH0 B JH EH1 K T", "S AH1 B JH IH0 K T"),
    #   subject default overridden: CMUdict lists the verb
    #   /S AH0 B JH EH1 K T/ first, but the noun dominates usage
    "permit":    _h("P ER0 M IH1 T", "P ER1 M IH2 T", default="verb"),
    "permits":   _h("P ER0 M IH1 T S", "P ER1 M IH2 T S", default="verb"),
    "conduct":   _h("K AH0 N D AH1 K T", "K AA1 N D AH0 K T",
                    default="verb"),
    "content":   _h("K AH0 N T EH1 N T", "K AA1 N T EH0 N T"),
    "contract":  _h("K AH0 N T R AE1 K T", "K AA1 N T R AE2 K T"),
    "contracts": _h("K AH0 N T R AE1 K T S", "K AA1 N T R AE2 K T S"),
    "contrast":  _h("K AH0 N T R AE1 S T", "K AA1 N T R AE0 S T"),
    "convert":   _h("K AH0 N V ER1 T", "K AA1 N V ER0 T"),
    "convict":   _h("K AH0 N V IH1 K T", "K AA1 N V IH0 K T"),
    "desert":    _h("D IH0 Z ER1 T", "D EH1 Z ER0 T"),
    "increase":  _h("IH0 N K R IY1 S", "IH1 N K R IY2 S", default="verb"),
    "decrease":  _h("D IH0 K R IY1 S", "D IY1 K R IY2 S", default="verb"),
    "insult":    _h("IH0 N S AH1 L T", "IH1 N S AH2 L T", default="verb"),
    "protest":   _h("P R AH0 T EH1 S T", "P R OW1 T EH2 S T"),
    "rebel":     _h("R IH0 B EH1 L", "R EH1 B AH0 L"),
    "suspect":   _h("S AH0 S P EH1 K T", "S AH1 S P EH2 K T",
                    default="verb"),
    "conflict":  _h("K AH0 N F L IH1 K T", "K AA1 N F L IH0 K T"),
    "transfer":  _h("T R AE0 N S F ER1", "T R AE1 N S F ER0",
                    default="verb"),
    "upset":     _h("AH0 P S EH1 T", "AH1 P S EH2 T", default="verb"),
    "console":   _h("K AH0 N S OW1 L", "K AA1 N S OW0 L"),
    "perfect":   _h("P ER0 F EH1 K T", "P ER1 F IH2 K T"),   # adj default
    # r4 expansion from the heteronym audit (text/analysis.py::
    # heteronym_audit over the in-repo corpus + documentation prose;
    # curated from the candidate-miss queue + the standard initial-
    # stress-noun / final-stress-verb alternation class)
    "address":   _h("AH0 D R EH1 S", "AE1 D R EH2 S"),
    "addresses": _h("AH0 D R EH1 S IH0 Z", "AE1 D R EH1 S IH0 Z"),
    "ally":      _h("AH0 L AY1", "AE1 L AY0"),
    "annex":     _h("AH0 N EH1 K S", "AE1 N EH2 K S"),
    "attribute": _h("AH0 T R IH1 B Y UW2 T", "AE1 T R AH0 B Y UW2 T"),
    "attributes": _h("AH0 T R IH1 B Y UW2 T S", "AE1 T R AH0 B Y UW2 T S"),
    "combat":    _h("K AH0 M B AE1 T", "K AA1 M B AE0 T"),
    "compact":   _h("K AH0 M P AE1 K T", "K AA1 M P AE0 K T"),
    "compound":  _h("K AH0 M P AW1 N D", "K AA1 M P AW0 N D"),
    "compounds": _h("K AH0 M P AW1 N D Z", "K AA1 M P AW0 N D Z"),
    "compress":  _h("K AH0 M P R EH1 S", "K AA1 M P R EH0 S",
                    default="verb"),
    #   compress default overridden: CMUdict lists the noun first, but
    #   the verb dominates usage (the noun is the cold-pack sense)
    "concert":   _h("K AH0 N S ER1 T", "K AA1 N S ER0 T"),
    "construct": _h("K AH0 N S T R AH1 K T", "K AA1 N S T R AH0 K T",
                    default="verb"),
    "contest":   _h("K AH0 N T EH1 S T", "K AA1 N T EH0 S T"),
    "contests":  _h("K AH0 N T EH1 S T S", "K AA1 N T EH0 S T S"),
    "defect":    _h("D IH0 F EH1 K T", "D IY1 F EH0 K T"),
    "defects":   _h("D IH0 F EH1 K T S", "D IY1 F EH0 K T S"),
    "digest":    _h("D AY0 JH EH1 S T", "D AY1 JH EH0 S T",
                    default="verb"),
    "discharge": _h("D IH0 S CH AA1 R JH", "D IH1 S CH AA2 R JH",
                    default="verb"),
    "discount":  _h("D IH0 S K AW1 N T", "D IH1 S K AW0 N T"),
    #   discount/discounts default overridden: CMUdict lists the verb
    #   first, but the noun dominates usage
    "discounts": _h("D IH0 S K AW1 N T S", "D IH1 S K AW2 N T S"),
    "escort":    _h("EH0 S K AO1 R T", "EH1 S K AO0 R T"),
    #   escort default overridden likewise (noun dominates)
    "exploit":   _h("EH2 K S P L OY1 T", "EH1 K S P L OY2 T"),
    "extract":   _h("IH0 K S T R AE1 K T", "EH1 K S T R AE2 K T",
                    default="verb"),
    "extracts":  _h("IH0 K S T R AE1 K T S", "EH1 K S T R AE2 K T S",
                    default="verb"),
    "impact":    _h("IH0 M P AE1 K T", "IH1 M P AE0 K T"),
    #   impact/impacts default overridden: noun dominates usage
    "impacts":   _h("IH0 M P AE1 K T S", "IH1 M P AE0 K T S"),
    "implant":   _h("IH0 M P L AE1 N T", "IH1 M P L AE2 N T",
                    default="verb"),
    "import":    _h("IH0 M P AO1 R T", "IH1 M P AO0 R T", default="verb"),
    "imports":   _h("IH0 M P AO1 R T S", "IH1 M P AO0 R T S",
                    default="verb"),
    "imprint":   _h("IH0 M P R IH1 N T", "IH1 M P R IH0 N T"),
    "incense":   _h("IH0 N S EH1 N S", "IH1 N S EH2 N S"),
    #   incense default overridden: noun dominates usage
    "incline":   _h("IH0 N K L AY1 N", "IH1 N K L AY0 N", default="verb"),
    "insert":    _h("IH0 N S ER1 T", "IH1 N S ER2 T", default="verb"),
    "inserts":   _h("IH0 N S ER1 T S", "IH1 N S ER2 T S", default="verb"),
    "misuse":    _h("M IH0 S Y UW1 Z", "M IH0 S Y UW1 S"),
    "pervert":   _h("P ER0 V ER1 T", "P ER1 V ER0 T"),
    "progresses": _h("P R OW0 G R EH1 S AH0 Z", "P R AA1 G R EH2 S AH0 Z",
                     default="verb"),
    #   progresses default overridden: the verb ("the work progresses")
    #   dominates usage
    "protests":  _h("P R AH0 T EH1 S T S", "P R OW1 T EH2 S T S"),
    "recall":    _h("R IH0 K AO1 L", "R IY1 K AO2 L", default="verb"),
    #   recall default overridden: CMUdict lists the noun first, but the
    #   verb dominates usage
    "recalls":   _h("R IH0 K AO1 L Z", "R IY1 K AO2 L Z", default="verb"),
    "refund":    _h("R IH0 F AH1 N D", "R IY1 F AH2 N D"),
    #   refund/refunds default overridden: noun dominates usage
    "refunds":   _h("R IH0 F AH1 N D Z", "R IY1 F AH2 N D Z"),
    "reject":    _h("R IH0 JH EH1 K T", "R IY1 JH EH0 K T",
                    default="verb"),
    "rejects":   _h("R IH0 JH EH1 K T S", "R IY1 JH EH0 K T S",
                    default="verb"),
    "research":  _h("R IY0 S ER1 CH", "R IY1 S ER0 CH"),
    #   research default overridden: noun dominates usage
    "subjects":  _h("S AH0 B JH EH1 K T S", "S AH1 B JH IH0 K T S"),
    "survey":    _h("S ER0 V EY1", "S ER1 V EY2"),
    #   survey/surveys default overridden: noun dominates usage
    "surveys":   _h("S ER0 V EY1 Z", "S ER1 V EY2 Z"),
    "torment":   _h("T AO0 R M EH1 N T", "T AO1 R M EH2 N T"),
    "transport": _h("T R AE0 N S P AO1 R T", "T R AE1 N S P AO0 R T",
                    default="verb"),
    # -ate words: verb /EY2 T/, noun-adjective /AH0 T/ (or /IH0 T/)
    "separate":  _h("S EH1 P ER0 EY2 T", "S EH1 P ER0 IH0 T"),  # adj default
    "estimate":  _h("EH1 S T AH0 M EY2 T", "EH1 S T AH0 M AH0 T"),
    "graduate":  _h("G R AE1 JH AH0 W EY2 T", "G R AE1 JH AH0 W AH0 T"),
    "moderate":  _h("M AA1 D ER0 EY2 T", "M AA1 D ER0 AH0 T"),
    "deliberate": _h("D IH0 L IH1 B ER0 EY2 T", "D IH0 L IH1 B ER0 AH0 T"),
    "alternate": _h("AO1 L T ER0 N EY2 T", "AO1 L T ER0 N AH0 T"),
    "associate": _h("AH0 S OW1 S IY0 EY2 T", "AH0 S OW1 S IY0 AH0 T"),
    "duplicate": _h("D UW1 P L AH0 K EY2 T", "D UW1 P L AH0 K AH0 T"),
    "advocate":  _h("AE1 D V AH0 K EY2 T", "AE1 D V AH0 K AH0 T"),
    "delegate":  _h("D EH1 L AH0 G EY2 T", "D EH1 L AH0 G AH0 T"),
    "laminate":  _h("L AE1 M AH0 N EY2 T", "L AE1 M AH0 N AH0 T"),
    "predicate": _h("P R EH1 D AH0 K EY2 T", "P R EH1 D IH0 K AH0 T"),
    "articulate": _h("AA0 R T IH1 K Y AH0 L EY2 T",
                     "AA0 R T IH1 K Y AH0 L AH0 T"),
    "approximate": _h("AH0 P R AA1 K S AH0 M EY2 T",
                      "AH0 P R AA1 K S AH0 M AH0 T"),
    "elaborate": _h("IH0 L AE1 B ER0 EY2 T", "IH0 L AE1 B R AH0 T"),
    "intimate":  _h("IH1 N T AH0 M EY2 T", "IH1 N T AH0 M AH0 T"),
    "syndicate": _h("S IH1 N D AH0 K EY2 T", "S IH1 N D IH0 K AH0 T"),
    "coordinate": _h("K OW0 AO1 R D AH0 N EY2 T",
                     "K OW0 AO1 R D AH0 N AH0 T"),
    # r5 curation-queue additions (VERDICT r4 item 4): stress heteronyms
    # surfaced by the top-100 frequency burn-down of the audit queue
    "update":    _h("AH0 P D EY1 T", "AH1 P D EY2 T"),
    "updates":   _h("AH0 P D EY1 T S", "AH1 P D EY2 T S"),
    "resume":    _h("R IH0 Z UW1 M", "R EH1 Z AH0 M EY2", default="verb"),
    "resumes":   _h("R IH0 Z UW1 M Z", "R EH1 Z AH0 M EY2 Z",
                    default="verb"),
}

# Tense heteronyms: (past, non-past, default) — past selected by perfect
# auxiliaries, non-past by ordinary verb cues, default otherwise.
TENSE_HETERONYMS: Dict[str, Tuple[Pron, Pron, str]] = {
    "read": (("R", "EH1", "D"), ("R", "IY1", "D"), "nonpast"),
    "wound": (("W", "AW1", "N", "D"), ("W", "UW1", "N", "D"), "nonpast"),
}

# Context-free curated readings: words whose RIGHT reading is not the
# lexicon's first variant and does not depend on POS (r5 curation-queue
# burn-down).  "re" in running prose is the prefix fragment of a split
# hyphenation ("re-engages"), not the solfege note CMUdict lists first;
# lowercase "pos" in technical prose is the initialism P-O-S.
PREFERRED_READINGS: Dict[str, Pron] = {
    "re":  ("R", "IY1"),
    "pos": ("P", "IY1", "OW1", "EH1", "S"),
}

#: r5 heteronym-queue curation (VERDICT r4 item 4: burn down the top-100
#: by corpus frequency).  Every word here was AUDITED against its CMUdict
#: variants and judged a single-reading word in General American: the
#: extra variants are free variation (flapped/elided consonants, vowel
#: quality jitter, spelling-pronunciations) or a reading foreign to
#: running prose (e.g. "polish" the nation-adjective is capitalized and
#: lost at normalization; lowercase is always P AA1 L IH0 SH).  The
#: first-variant lookup the cascade already does is correct for all of
#: them, so the audit (text/analysis.py::heteronym_audit) counts them as
#: curated coverage rather than candidate misses.
CURATED_SINGLE_READING = frozenset("""
    hundred one whisper gentle always twenty zero thirty thousand seventy
    reference references vs sixteen every data length lengths eleven
    epoch epochs new fourteen optional target inside process requests
    eighteen fifteen without against identical boundary boundaries where
    last while before carries carry carried paragraph exit within ab
    drop counterpart second seconds kept documented next top directory
    beyond fires cache caches production around already expansion cost
    costs required naturally coverage rounds actually cannot onto op why
    directly status quantitative predicates un natural de id anywhere
    exists integration recovery economics resort protocol updated get
    gets reading lists neural quantified actual intervention polish
    affix romance job hinted rather shuffling hosts whenever discovery
    reported paths machinery effective empty everywhere complex lever
    current fall option effect persists hour disappears zeroed interface
    predicts toward printer exploration prob auxiliary manifests
    upgrades center fidelity
""".split())


def disambiguate(word: str, prev: Optional[str] = None) -> Optional[Pron]:
    """Resolve ``word`` given the previous normalized word.

    Returns the chosen pronunciation, or None if ``word`` is not in the
    homograph tables (callers fall through to the ordinary G2P cascade).
    """
    preferred = PREFERRED_READINGS.get(word)
    if preferred is not None:
        return preferred
    tense = TENSE_HETERONYMS.get(word)
    if tense is not None:
        past, nonpast, default = tense
        if prev in _PAST_CUES:
            return past
        if prev in _VERB_CUES:
            return nonpast
        return past if default == "past" else nonpast
    entry = HOMOGRAPHS.get(word)
    if entry is None:
        return None
    if prev in _VERB_CUES:
        return entry.verb
    if prev in _NONVERB_CUES:
        return entry.other
    return entry.verb if entry.default == "verb" else entry.other
