"""Porter2 (Snowball English) stemmer.

Implemented from the published Snowball English algorithm description so the
vocabulary matches the reference, which stems with a Porter2 library
(reference: parser/parser.go:187 using surgebase/porter2). Golden-tested
against NLTK's Snowball English stemmer (another independent implementation
of the same algorithm) in tests/test_porter2.py.
"""

from __future__ import annotations

_VOWELS = frozenset("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDINGS = frozenset("cdeghkmnrt")

_EXCEPTIONS1 = {
    "skis": "ski",
    "skies": "sky",
    "dying": "die",
    "lying": "lie",
    "tying": "tie",
    "idly": "idl",
    "gently": "gentl",
    "ugly": "ugli",
    "early": "earli",
    "only": "onli",
    "singly": "singl",
    "sky": "sky",
    "news": "news",
    "howe": "howe",
    "atlas": "atlas",
    "cosmos": "cosmos",
    "bias": "bias",
    "andes": "andes",
}

_EXCEPTIONS2 = frozenset(
    ("inning", "outing", "canning", "herring", "earring", "proceed", "exceed", "succeed")
)

# Step 2 suffix -> replacement, checked longest-first. Conditional entries
# ("ogi", "li") are handled separately below.
_STEP2 = (
    ("ization", "ize"),
    ("ational", "ate"),
    ("fulness", "ful"),
    ("ousness", "ous"),
    ("iveness", "ive"),
    ("tional", "tion"),
    ("biliti", "ble"),
    ("lessli", "less"),
    ("entli", "ent"),
    ("ation", "ate"),
    ("alism", "al"),
    ("aliti", "al"),
    ("ousli", "ous"),
    ("iviti", "ive"),
    ("fulli", "ful"),
    ("enci", "ence"),
    ("anci", "ance"),
    ("abli", "able"),
    ("izer", "ize"),
    ("ator", "ate"),
    ("alli", "al"),
    ("bli", "ble"),
)

_STEP3 = (
    ("ational", "ate"),
    ("tional", "tion"),
    ("alize", "al"),
    ("icate", "ic"),
    ("iciti", "ic"),
    ("ical", "ic"),
    ("ful", ""),
    ("ness", ""),
)

_STEP4_SUFFIXES = (
    "ement",
    "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize", "ion",
    "al", "er", "ic",
)


def _is_vowel(ch: str) -> bool:
    return ch in _VOWELS


def _mark_consonant_ys(word: str) -> str:
    out = []
    prev_vowel = False
    for i, ch in enumerate(word):
        if ch == "y" and (i == 0 or prev_vowel):
            out.append("Y")
            prev_vowel = False
        else:
            out.append(ch)
            prev_vowel = ch in _VOWELS
    return "".join(out)


def _find_r1(word: str) -> int:
    # Special prefixes fix R1 (Snowball: gener-, commun-, arsen-).
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            return len(prefix)
    return _region_after_vc(word, 0)


def _region_after_vc(word: str, start: int) -> int:
    """Index after the first vowel-followed-by-non-vowel pair at/after start."""
    n = len(word)
    i = start
    while i < n and not _is_vowel(word[i]):
        i += 1
    while i < n and _is_vowel(word[i]):
        i += 1
    return min(i + 1, n) if i < n else n


def _ends_short_syllable(word: str) -> bool:
    n = len(word)
    if n == 2:
        return _is_vowel(word[0]) and not _is_vowel(word[1])
    if n >= 3:
        return (
            not _is_vowel(word[-3])
            and _is_vowel(word[-2])
            and word[-1] not in _VOWELS
            and word[-1] not in "wxY"
        )
    return False


def stem(word: str) -> str:
    """Stem a single lowercase token. Tokens of length <= 2 pass through."""
    if len(word) <= 2:
        return word

    if word[0] == "'":
        word = word[1:]
        if len(word) <= 2:
            return word

    exc = _EXCEPTIONS1.get(word)
    if exc is not None:
        return exc

    word = _mark_consonant_ys(word)
    r1 = _find_r1(word)
    r2 = _region_after_vc(word, r1)

    # --- Step 0: strip apostrophe suffixes ---
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # --- Step 1a ---
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if any(_is_vowel(c) for c in word[:-2]):
            word = word[:-1]

    if word in _EXCEPTIONS2:
        return word

    # --- Step 1b ---
    suffix1b = next(
        (s for s in ("eedly", "ingly", "edly", "eed", "ing", "ed") if word.endswith(s)),
        None,
    )
    if suffix1b in ("eed", "eedly"):
        if len(word) - len(suffix1b) >= r1:
            word = word[: -len(suffix1b)] + "ee"
    elif suffix1b is not None:
        stem_part = word[: -len(suffix1b)]
        if any(_is_vowel(c) for c in stem_part):
            word = stem_part
            if word.endswith(("at", "bl", "iz")):
                word += "e"
            elif word.endswith(_DOUBLES):
                word = word[:-1]
            elif r1 >= len(word) and _ends_short_syllable(word):
                word += "e"

    # --- Step 1c ---
    if len(word) > 2 and word[-1] in "yY" and not _is_vowel(word[-2]):
        word = word[:-1] + "i"

    # --- Step 2 (longest suffix; act only if it lies in R1) ---
    n = len(word)
    for suf, repl in _STEP2:
        if word.endswith(suf):
            if n - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ogi"):
            if n - 3 >= r1 and len(word) >= 4 and word[-4] == "l":
                word = word[:-1]
        elif word.endswith("li"):
            if n - 2 >= r1 and len(word) >= 3 and word[-3] in _LI_ENDINGS:
                word = word[:-2]

    # --- Step 3 ---
    n = len(word)
    for suf, repl in _STEP3:
        if word.endswith(suf):
            if n - len(suf) >= r1:
                word = word[: -len(suf)] + repl
            break
    else:
        if word.endswith("ative") and n - 5 >= r1 and n - 5 >= r2:
            word = word[:-5]

    # --- Step 4 (longest suffix; act only if it lies in R2) ---
    n = len(word)
    for suf in _STEP4_SUFFIXES:
        if word.endswith(suf):
            if n - len(suf) >= r2:
                if suf == "ion":
                    if len(word) >= 4 and word[-4] in "st":
                        word = word[:-3]
                else:
                    word = word[: -len(suf)]
            break

    # --- Step 5 ---
    n = len(word)
    if word.endswith("e"):
        if n - 1 >= r2 or (n - 1 >= r1 and not _ends_short_syllable(word[:-1])):
            word = word[:-1]
    elif word.endswith("l"):
        if n - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
            word = word[:-1]

    return word.replace("Y", "y")
