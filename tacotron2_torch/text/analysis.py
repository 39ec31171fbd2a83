"""G2P coverage / divergence analysis.

The reference's `g2p_en` hides its OOV behavior inside a neural LTS model
(reference: src/text.py:35); this framework's G2P is a transparent
cascade (lexicon -> apostrophe restore -> morphology -> rule LTS), so its
coverage can be AUDITED: this module measures, for any transcript set,
what fraction of running tokens each stage resolves and which words fall
through to the rule LTS (the only stage whose output can diverge
meaningfully from g2p_en).

An own copy of ``tacotron2_tpu/text/analysis.py`` on the port's ``G2p``,
lexicon and homograph tables.

CLI:  python -m tacotron2_torch.text.analysis metadata.csv [--column text]
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

from .g2p import G2p
from .normalize import normalize_text


def g2p_coverage(texts: Iterable[str], g2p: G2p | None = None,
                 top_n: int = 50) -> Dict:
    """Token-level resolution statistics over normalized transcripts.

    Returns a dict with running-token counts per resolution stage
    (``lexicon`` / ``apostrophe`` / ``morphology`` / ``lts``), the OOV rate
    (fraction of running tokens needing ANY fallback past the lexicon),
    the hard-OOV rate (fraction hitting the rule LTS), and the ``top_n``
    most frequent LTS words with their produced pronunciations.
    """
    g2p = g2p or G2p()
    token_counts: Counter = Counter()
    for text in texts:
        token_counts.update(normalize_text(text).split())

    stage_tokens = Counter()
    stage_types = Counter()
    lts_words: Counter = Counter()
    for word, count in token_counts.items():   # unique words once each
        stage = g2p.resolution(word)
        stage_tokens[stage] += count
        stage_types[stage] += 1
        if stage == "lts":
            lts_words[word] += count

    total = sum(token_counts.values())
    fallback = total - stage_tokens["lexicon"]
    report = {
        "total_tokens": total,
        "unique_words": len(token_counts),
        "tokens_by_stage": dict(stage_tokens),
        "types_by_stage": dict(stage_types),
        "oov_rate": (fallback / total) if total else 0.0,
        "hard_oov_rate": (stage_tokens["lts"] / total) if total else 0.0,
        "top_lts_words": [
            {"word": w, "count": c, "phones": list(g2p.pronounce(w))}
            for w, c in lts_words.most_common(top_n)],
    }
    return report


def _material_variants(variants: List[Tuple[str, ...]]) -> bool:
    """Do >= 2 CMUdict variants differ as READINGS — different segments
    or a moved primary stress — rather than unstressed-schwa jitter?"""
    def key(phones: Tuple[str, ...]):
        # Skeleton = consonants + STRESSED vowels.  Unstressed (stress-0)
        # vowels drop entirely: both their presence ("gentle" with or
        # without the schwa) and their quality ("the" as DH AH0 vs
        # DH IY0) are free variation, not readings — while a stressed
        # AH1-vs-IH1 difference survives.  Primary-stress positions are
        # computed on the COLLAPSED skeleton, so an unstressed-vowel
        # insertion before the stressed vowel can't fake a stress move.
        kept = [p for p in phones if not p.endswith("0")]
        segs = tuple(p.rstrip("012") for p in kept)
        primary = tuple(i for i, p in enumerate(kept) if p.endswith("1"))
        return segs, primary

    seen = {key(v) for v in variants}
    return len(seen) >= 2


#: Closed-class words whose CMUdict variants are weak-form (citation vs
#: reduced) or elision alternation — prosody-driven, never POS-driven, so
#: they are pure noise in a heteronym curation queue.  ("read"/"lives"/
#: "use" style POS heteronyms are all open-class.)
_WEAK_FORMS = frozenset(
    "the a an and or to of for at on in into with as than then them that "
    "this these those was were is are be been being have has had do does "
    "did will would shall should can could may might must am but if when us "
    "what which who whom because from by about just your our their his her "
    "its my you we they he she it i not no nor so such per via upon".split())


def heteronym_audit(texts: Iterable[str], top_n: int = 40) -> Dict:
    """Heteronym coverage over real text (the reference resolves these
    with g2p_en's POS tagger, reference: src/text.py:35; this framework
    uses the curated table in homographs.py).

    A running token is COVERED when the table disambiguates it, and a
    CANDIDATE MISS when CMUdict lists materially different readings for
    it (different segments or a moved primary stress) that the table
    does not know.  The miss list is a curation queue, not an error
    count — many multi-variant CMUdict words are free variation, not
    POS-driven heteronyms."""
    from .homographs import (CURATED_SINGLE_READING, HOMOGRAPHS,
                             PREFERRED_READINGS, TENSE_HETERONYMS)
    from .lexicon import find_lexicon_path, parse_cmudict_variants

    variants = parse_cmudict_variants(find_lexicon_path())
    token_counts: Counter = Counter()
    for text in texts:
        token_counts.update(normalize_text(text).split())

    covered = Counter()
    curated = Counter()
    misses = Counter()
    for word, count in token_counts.items():
        if (word in HOMOGRAPHS or word in TENSE_HETERONYMS
                or word in PREFERRED_READINGS):
            covered[word] += count
        elif word in CURATED_SINGLE_READING:
            # audited: variants are free variation, first-variant lookup
            # is the right reading (homographs.py::CURATED_SINGLE_READING)
            curated[word] += count
        elif word not in _WEAK_FORMS \
                and len(variants.get(word, ())) >= 2 \
                and _material_variants(variants[word]):
            misses[word] += count

    total = sum(token_counts.values())
    n_miss = sum(misses.values())
    return {
        "total_tokens": total,
        "covered_tokens": sum(covered.values()),
        "covered_words": dict(covered.most_common()),
        "curated_single_reading_tokens": sum(curated.values()),
        "candidate_miss_tokens": n_miss,
        "candidate_miss_rate": (n_miss / total) if total else 0.0,
        "top_candidate_misses": [
            {"word": w, "count": c,
             "variants": [" ".join(v) for v in variants[w]]}
            for w, c in misses.most_common(top_n)],
    }


def format_report(report: Dict) -> str:
    lines = [
        f"tokens: {report['total_tokens']}  "
        f"unique words: {report['unique_words']}",
        f"resolution (running tokens): "
        + "  ".join(f"{k}={v}" for k, v in
                    sorted(report["tokens_by_stage"].items())),
        f"OOV rate (any fallback): {report['oov_rate']:.4%}",
        f"hard-OOV rate (rule LTS): {report['hard_oov_rate']:.4%}",
    ]
    if report["top_lts_words"]:
        lines.append("top LTS words:")
        for e in report["top_lts_words"]:
            lines.append(f"  {e['word']!r} x{e['count']}: "
                         f"{' '.join(e['phones'])}")
    return "\n".join(lines)


def _main() -> None:
    import argparse
    import csv
    import json
    import sys

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("metadata", help="CSV with a text column (or a plain "
                                    ".txt file, one utterance per line)")
    p.add_argument("--column", default="text")
    p.add_argument("--json", action="store_true")
    p.add_argument("--heteronyms", action="store_true",
                   help="run the heteronym coverage audit instead of the "
                        "G2P stage-coverage report")
    args = p.parse_args()

    texts: List[str] = []
    if args.metadata.endswith(".txt"):
        with open(args.metadata, "r", encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
    else:
        with open(args.metadata, "r", encoding="utf-8") as f:
            for row in csv.DictReader(f):
                texts.append(row[args.column])

    report = (heteronym_audit(texts) if args.heteronyms
              else g2p_coverage(texts))
    if args.json:
        json.dump(report, sys.stdout, indent=2)
        print()
    elif args.heteronyms:
        print(f"tokens: {report['total_tokens']}  covered heteronym "
              f"tokens: {report['covered_tokens']}  candidate misses: "
              f"{report['candidate_miss_tokens']} "
              f"({report['candidate_miss_rate']:.4%})")
        for e in report["top_candidate_misses"]:
            print(f"  {e['word']!r} x{e['count']}: "
                  f"{'; '.join(e['variants'][:3])}")
    else:
        print(format_report(report))


if __name__ == "__main__":
    _main()
