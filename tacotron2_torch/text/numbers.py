"""Integer-to-words expansion.

Standalone replacement for the `inflect` engine used by the reference
normalizer (reference: src/text.py:10,20).  Only `number_to_words` on
non-negative integer strings is needed there (the regex captures `(\\d+)`
digit runs only), so this implements exactly that, matching inflect's output
style for such inputs: "and" between hundreds and tens, hyphenated tens
("twenty-three"), comma-joined thousand groups, and "zero" for 0.

Examples (parity with inflect 7.x):
    0        -> "zero"
    105      -> "one hundred and five"
    1001     -> "one thousand and one"
    1234567  -> "one million, two hundred and thirty-four thousand,
                 five hundred and sixty-seven"

Downstream normalization replaces hyphens/commas with spaces, so small
stylistic differences in separators would be erased anyway; content words
are what matters for G2P.
"""

from __future__ import annotations

_ONES = (
    'zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven', 'eight',
    'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen', 'fifteen',
    'sixteen', 'seventeen', 'eighteen', 'nineteen',
)
_TENS = (
    '', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
    'eighty', 'ninety',
)
# Short-scale group names; enough for any digit run one plausibly encounters.
_SCALES = (
    '', 'thousand', 'million', 'billion', 'trillion', 'quadrillion',
    'quintillion', 'sextillion', 'septillion', 'octillion', 'nonillion',
    'decillion',
)


def _two_digits(n: int) -> str:
    """Words for 0 < n < 100."""
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[ones]}"


def _three_digits(n: int) -> str:
    """Words for 0 < n < 1000, with inflect-style 'and'."""
    hundreds, rest = divmod(n, 100)
    if hundreds == 0:
        return _two_digits(rest)
    if rest == 0:
        return f"{_ONES[hundreds]} hundred"
    return f"{_ONES[hundreds]} hundred and {_two_digits(rest)}"


def number_to_words(value: int | str) -> str:
    """Spell out a non-negative integer (or digit string) in English words."""
    n = int(value)
    if n < 0:
        return "minus " + number_to_words(-n)
    if n == 0:
        return _ONES[0]

    # Split into base-1000 groups, least significant first.
    groups = []
    while n > 0:
        n, g = divmod(n, 1000)
        groups.append(g)
    if len(groups) > len(_SCALES):
        # Beyond named scales: read digit by digit (inflect would use
        # higher -illions; digit reading is a safe, intelligible fallback).
        return ' '.join(_ONES[int(d)] for d in str(value))

    parts = []  # most significant first
    for idx in range(len(groups) - 1, -1, -1):
        g = groups[idx]
        if g == 0:
            continue
        words = _three_digits(g)
        if _SCALES[idx]:
            words = f"{words} {_SCALES[idx]}"
        parts.append((idx, g, words))

    # Join groups: ", " normally; " and " before a trailing sub-hundred group
    # (inflect: 1001 -> "one thousand and one", 1000100 -> "one million, one hundred").
    out = parts[0][2]
    for i in range(1, len(parts)):
        idx, g, words = parts[i]
        last = (i == len(parts) - 1)
        if last and idx == 0 and g < 100:
            out += f" and {words}"
        else:
            out += f", {words}"
    return out
