"""The port's copy of `chatterbox_embed_tpu/text/sanitizer.py`, which imports no
jax. Deep text sanitisation for TTS input (reference behaviors:
chunking/text_sanitizer.py — unicode normalisation, markup stripping,
number/currency/time verbalisation, URL verbalisation, abbreviation
expansion, story-break mapping, per-language charset validation).

Implemented dependency-free (the reference leans on `inflect`; we ship our own
number-to-words engine for English and digit-spelling fallbacks elsewhere).
"""
from __future__ import annotations

import re
import unicodedata
from typing import List, Optional, Tuple

STORY_BREAK_TOKEN = "<STORY_BREAK>"

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (1000, "thousand"), (100, "hundred")]


def number_to_words(n: int) -> str:
    """English cardinal words for |n| < 1e12."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, rem = divmod(n, 10)
        return _TENS[tens] + (f"-{_ONES[rem]}" if rem else "")
    for value, name in _SCALE:
        if n >= value:
            major, rem = divmod(n, value)
            head = f"{number_to_words(major)} {name}"
            return head + (f" {number_to_words(rem)}" if rem else "")
    return str(n)


def digits_to_words(digits: str) -> str:
    return " ".join(_ONES[int(d)] for d in digits if d.isdigit())


def year_to_words(year: int) -> str:
    """Natural year reading: 1984 -> nineteen eighty-four, 2005 -> two thousand five."""
    if 1000 <= year <= 1999 or 2100 <= year <= 9999:
        hi, lo = divmod(year, 100)
        if lo == 0:
            return f"{number_to_words(hi)} hundred"
        if lo < 10:
            return f"{number_to_words(hi)} oh {number_to_words(lo)}"
        return f"{number_to_words(hi)} {number_to_words(lo)}"
    if 2000 <= year <= 2099:
        return number_to_words(year)
    return number_to_words(year)


# language -> extra letters allowed beyond ASCII (reference supports
# en/es/fr/de/it/pt/da/no/sv)
_LANG_EXTRA = {
    "en": "",
    "es": "áéíóúüñÁÉÍÓÚÜÑ¿¡",
    "fr": "àâäçéèêëîïôöùûüÿœæÀÂÄÇÉÈÊËÎÏÔÖÙÛÜŸŒÆ",
    "de": "äöüßÄÖÜ",
    "it": "àèéìíîòóùúÀÈÉÌÍÎÒÓÙÚ",
    "pt": "áâãàçéêíóôõúüÁÂÃÀÇÉÊÍÓÔÕÚÜ",
    "da": "æøåÆØÅ",
    "no": "æøåÆØÅ",
    "sv": "åäöÅÄÖ",
}

_ABBREVIATIONS = {
    "mr.": "mister", "mrs.": "missus", "ms.": "miss", "dr.": "doctor",
    "prof.": "professor", "st.": "saint", "jr.": "junior", "sr.": "senior",
    "vs.": "versus", "etc.": "et cetera", "e.g.": "for example",
    "i.e.": "that is", "approx.": "approximately", "dept.": "department",
    "min.": "minutes", "max.": "maximum", "no.": "number",
}

_CURRENCY = {"$": "dollars", "€": "euros", "£": "pounds", "¥": "yen", "kr": "kroner"}


class AdvancedTextSanitizer:
    """Normalise arbitrary story text into a clean TTS-friendly form."""

    def __init__(self, language: str = "en"):
        self.language = language

    # -- stages ------------------------------------------------------------

    def normalize_unicode(self, text: str) -> str:
        text = unicodedata.normalize("NFKC", text)
        text = text.replace(" ", " ").replace("​", "")
        # typographic punctuation -> plain (reference: _normalize_typographic_punctuation)
        for old, new in [("“", '"'), ("”", '"'), ("‘", "'"),
                         ("’", "'"), ("«", '"'), ("»", '"'),
                         ("…", "..."), ("−", "-")]:
            text = text.replace(old, new)
        return text

    def mark_story_breaks(self, text: str) -> str:
        """The asterism char marks a dramatic section break (reference:
        deep_clean maps it to <STORY_BREAK>)."""
        text = text.replace("⁂", f"\n\n{STORY_BREAK_TOKEN}\n\n")
        text = re.sub(r"\n\s*\*\s*\*\s*\*\s*\n", f"\n\n{STORY_BREAK_TOKEN}\n\n", text)
        return text

    def remove_markup(self, text: str) -> str:
        text = re.sub(r"<(?!STORY_BREAK)[^>\n]{1,80}>", " ", text)      # html-ish tags
        text = re.sub(r"\*\*([^*\n]+)\*\*", r"\1", text)  # bold
        text = re.sub(r"(?<!\*)\*([^*\n]+)\*(?!\*)", r"\1", text)  # italics
        text = re.sub(r"__([^_\n]+)__", r"\1", text)
        text = re.sub(r"(?<!_)_([^_\n]+)_(?!_)", r"\1", text)
        text = re.sub(r"^#{1,6}\s*", "", text, flags=re.M)  # headings
        text = re.sub(r"`{1,3}([^`\n]*)`{1,3}", r"\1", text)
        text = re.sub(r"\[([^\]\n]*)\]\([^)\n]*\)", r"\1", text)  # links
        return text

    def verbalize_urls(self, text: str) -> str:
        def repl(m: re.Match) -> str:
            host = re.sub(r"^https?://(www\.)?", "", m.group(0)).split("/")[0]
            host = host.replace(".", " dot ")
            return host

        return re.sub(r"https?://\S+|www\.\S+", repl, text)

    def verbalize_currency(self, text: str) -> str:
        def repl(m: re.Match) -> str:
            sym, amount = m.group(1), m.group(2).replace(",", "")
            if "." in amount:
                whole, cents = amount.split(".")
                words = f"{number_to_words(int(whole))} {_CURRENCY[sym]}"
                if int(cents or 0):
                    words += f" and {number_to_words(int(cents))} cents"
                return words
            return f"{number_to_words(int(amount))} {_CURRENCY[sym]}"

        return re.sub(r"([$€£¥])\s?(\d[\d,]*(?:\.\d+)?)", repl, text)

    def verbalize_times(self, text: str) -> str:
        def repl(m: re.Match) -> str:
            h, mnt = int(m.group(1)), int(m.group(2))
            suffix = (" " + m.group(3).replace(".", "").lower()) if m.group(3) else ""
            if mnt == 0:
                return f"{number_to_words(h)} o'clock" if not suffix else f"{number_to_words(h)}{suffix}"
            if mnt < 10:
                return f"{number_to_words(h)} oh {number_to_words(mnt)}{suffix}"
            return f"{number_to_words(h)} {number_to_words(mnt)}{suffix}"

        return re.sub(r"\b(\d{1,2}):(\d{2})\s?([ap]\.?m\.?)?\b", repl, text, flags=re.I)

    def verbalize_temperatures(self, text: str) -> str:
        def repl(m: re.Match) -> str:
            unit = {"C": "celsius", "F": "fahrenheit"}[m.group(2).upper()]
            return f"{number_to_words(int(m.group(1)))} degrees {unit}"

        return re.sub(r"(-?\d+)\s?°\s?([CF])\b", repl, text)

    def verbalize_percents(self, text: str) -> str:
        return re.sub(r"(\d+(?:\.\d+)?)\s?%",
                      lambda m: self._decimal_words(m.group(1)) + " percent", text)

    def _decimal_words(self, s: str) -> str:
        if "." in s:
            whole, frac = s.split(".")
            return f"{number_to_words(int(whole))} point {digits_to_words(frac)}"
        return number_to_words(int(s))

    def verbalize_ranges(self, text: str) -> str:
        return re.sub(r"\b(\d+)\s?[-–]\s?(\d+)\b",
                      lambda m: f"{number_to_words(int(m.group(1)))} to "
                                f"{number_to_words(int(m.group(2)))}", text)

    def verbalize_ordinals(self, text: str) -> str:
        ord_map = {1: "first", 2: "second", 3: "third", 5: "fifth", 8: "eighth",
                   9: "ninth", 12: "twelfth"}

        def repl(m: re.Match) -> str:
            n = int(m.group(1))
            if n in ord_map:
                return ord_map[n]
            w = number_to_words(n)
            if w.endswith("y"):
                return w[:-1] + "ieth"
            return w + "th"

        return re.sub(r"\b(\d+)(?:st|nd|rd|th)\b", repl, text)

    def normalize_numbers(self, text: str) -> str:
        # Protect/restore pass (reference: chunking/text_sanitizer.py
        # normalize_numbers): ISO dates and semantic versions must survive
        # verbalisation intact — "2026-01-22" must not hit the range/year
        # regexes, "v2.1.3" must not hit the decimal regex. The placeholder
        # keys are \w-only, so every \b-anchored number regex skips them.
        protected: dict = {}

        def _protect(pattern: str, label: str, s: str) -> str:
            def repl(m: re.Match) -> str:
                key = f"__{label}{len(protected)}__"
                protected[key] = m.group(0)
                return key
            return re.sub(pattern, repl, s)

        text = _protect(r"\b\d{4}-\d{2}-\d{2}\b", "DATE", text)
        text = _protect(r"\b[vV]?\d+(?:\.\d+){2,}\b", "VER", text)
        # phone numbers read digit-by-digit in groups (the reference splits
        # the groups with spaces; spelling the digits is the TTS-safe form)
        text = re.sub(r"\b(\d{3})-(\d{3})-(\d{4})\b",
                      lambda m: ", ".join(digits_to_words(g) for g in m.groups()),
                      text)
        text = self.verbalize_currency(text)
        text = self.verbalize_temperatures(text)
        text = self.verbalize_times(text)
        text = self.verbalize_percents(text)
        text = self.verbalize_ordinals(text)
        text = self.verbalize_ranges(text)
        # years in context
        text = re.sub(r"\b(1[0-9]{3}|20[0-9]{2})\b",
                      lambda m: year_to_words(int(m.group(1))), text)
        # decimals
        text = re.sub(r"\b\d+\.\d+\b", lambda m: self._decimal_words(m.group(0)), text)
        # plain integers (with thousands separators)
        text = re.sub(r"\b\d[\d,]*\b",
                      lambda m: number_to_words(int(m.group(0).replace(",", ""))), text)
        for key, val in protected.items():
            text = text.replace(key, val)
        return text

    def expand_contractions_possessives(self, text: str) -> str:
        """Strip intra-word apostrophes so the model never spells them as a
        separate token ("Carl s"): Carl's -> Carls, boys' -> boys,
        don't -> dont, rock'n'roll -> rocknroll (reference:
        chunking/text_sanitizer.py:663-681
        _expand_contractions_and_possessives)."""
        text = re.sub(r"\b([A-Za-z]+)'s\b", r"\1s", text)
        text = re.sub(r"\b([A-Za-z]+)s'\b", r"\1s", text)
        text = re.sub(r"(?<=\w)'(?=\w)", "", text)
        return text

    def verbalize_equations(self, text: str) -> str:
        """Light inline-equation verbalization — E=mc^2, x_1=3.14, a*b=c —
        not a math parser (reference: text_sanitizer.py:325-392
        _verbalize_simple_equations). Runs PER SENTENCE, only on sentences
        that look math-ish (= ^ { } or a single-letter subscript), so one
        equation somewhere cannot turn a whole story's hyphens into "minus"
        — and the <STORY_BREAK> marker's underscore never opens the gate."""

        def _mathish(seg: str) -> bool:
            seg = seg.replace(STORY_BREAK_TOKEN, " ")
            if any(ch in seg for ch in ("=", "^", "{", "}")):
                return True
            # '_' gates only as a single-letter subscript (x_1) — never on
            # snake_case words or the sanitizer's own placeholder keys
            return re.search(r"\b[A-Za-z]\s*_\s*[A-Za-z0-9{]", seg) is not None

        def _exp(m: re.Match) -> str:
            base, exp = m.group(1), m.group(2)
            if exp == "2":
                return f"{base} squared"
            if exp == "3":
                return f"{base} cubed"
            return f"{base} to the power of {exp}"

        # operands for the +/-/* rules: a number or a SINGLE-letter variable,
        # so compound words (well-known, mother-in-law) survive even inside
        # a math-ish sentence
        opnd = r"(\d+(?:\.\d+)?|\b[A-Za-z])"
        rhs = r"(?=\d|[A-Za-z]\b|[\(\[])"

        def _verbalize(seg: str) -> str:
            seg = re.sub(r"([A-Za-z0-9\)\]])\s*\^\s*\{\s*([0-9]+)\s*\}", _exp, seg)
            seg = re.sub(r"([A-Za-z0-9\)\]])\s*\^\s*([0-9]+)", _exp, seg)
            # subscripts (single-letter base at a word boundary only)
            seg = re.sub(r"\b([A-Za-z])\s*_\s*\{\s*([A-Za-z0-9]+)\s*\}", r"\1 sub \2", seg)
            seg = re.sub(r"\b([A-Za-z])\s*_\s*([A-Za-z0-9]+)\b", r"\1 sub \2", seg)
            if "=" in seg:
                # split compact products next to a verbalized exponent: mc squared
                seg = re.sub(r"\b([A-Za-z])([A-Za-z])\s+(squared|cubed)\b",
                             r"\1 \2 \3", seg)
                seg = re.sub(r"\b([A-Za-z])([A-Za-z])\s+(to the power of)\b",
                             r"\1 \2 \3", seg)
            seg = seg.replace("{", " ").replace("}", " ")
            seg = re.sub(r"(?<=[A-Za-z0-9\)\]])\s*=\s*(?=[A-Za-z0-9\(\[\]-])",
                         " equals ", seg)
            seg = re.sub(opnd + r"\s*\+\s*" + rhs, r"\1 plus ", seg)
            seg = re.sub(opnd + r"\s*-\s*" + rhs, r"\1 minus ", seg)
            seg = re.sub(r"\bequals\s*-\s*(\d+)\b", r"equals minus \1", seg)
            seg = re.sub(opnd + r"\s*\*\s*" + rhs, r"\1 times ", seg)
            seg = re.sub(r"(\d)\s*/\s*(\w)", r"\1 divided by \2", seg)
            seg = re.sub(r"(\w)\s*/\s*(\d)", r"\1 divided by \2", seg)
            seg = re.sub(r"\b([A-Za-z])\s*/\s*([A-Za-z])\b", r"\1 divided by \2", seg)
            return seg

        if not _mathish(text):
            return text
        # sentence/line segmentation keeps every separator so the join is exact
        parts = re.split(r"(\n+|(?<=[.!?])\s+)", text)
        return "".join(_verbalize(p) if i % 2 == 0 and _mathish(p) else p
                       for i, p in enumerate(parts))

    def expand_abbreviations(self, text: str) -> str:
        def repl(m: re.Match) -> str:
            word = m.group(0)
            expansion = _ABBREVIATIONS[word.lower()]
            return expansion.capitalize() if word[0].isupper() else expansion

        pattern = r"\b(" + "|".join(re.escape(a) for a in _ABBREVIATIONS) + r")"
        return re.sub(pattern, repl, text, flags=re.I)

    def clean_spacing(self, text: str) -> str:
        text = re.sub(r"[ \t]+", " ", text)
        text = re.sub(r" ([.,!?;:])", r"\1", text)
        text = re.sub(r"([.,!?;:])(?=[A-Za-z])", r"\1 ", text)
        text = re.sub(r"\n{3,}", "\n\n", text)
        text = re.sub(r"([.!?]){2,}", r"\1", text)
        return text.strip()

    def validate_text_for_language(self, text: str, language: str = "en"
                                   ) -> Tuple[bool, Optional[str], Optional[List[str]]]:
        """Check the text only uses the language's charset (reference:
        validate_text_for_language). Returns (ok, error, offending_chars)."""
        if language not in _LANG_EXTRA:
            return False, f"unsupported language: {language}", None
        allowed_extra = _LANG_EXTRA[language]
        bad = sorted({c for c in text
                      if not (c.isascii() or c in allowed_extra or c in "’‘“”—–…")})
        if bad:
            return False, f"characters not valid for '{language}'", bad
        return True, None, None

    def deep_clean(self, text: str) -> str:
        """Full pipeline (reference: deep_clean at text_sanitizer.py:805-860).

        Stage order follows the reference: unicode -> markup -> contractions
        -> URLs -> equations -> numbers -> abbreviations -> spacing -> final
        normalization (capitalize, guaranteed terminal punctuation, charset
        filter). One intentional delta: the reference strips <STORY_BREAK>
        markers here (:841) because it re-derives break positions from
        character offsets; we keep them — tts.chunk_text splits on the token
        exactly (tts.py docstring explains why that is more robust)."""
        if not text or not text.strip():
            # reference text_sanitizer.py:807-808
            return "You need to add some text for me to talk."
        text = self.normalize_unicode(text)
        text = self.mark_story_breaks(text)
        text = self.remove_markup(text)
        text = self.expand_contractions_possessives(text)
        text = self.verbalize_urls(text)
        text = self.verbalize_equations(text)
        if self.language == "en":
            text = self.normalize_numbers(text)
            text = self.expand_abbreviations(text)
        text = self.clean_spacing(text)
        # Final normalization (reference :844-856). A trailing story break
        # has no content after it — drop it rather than punctuate past it.
        while text.endswith(STORY_BREAK_TOKEN):
            text = text[: -len(STORY_BREAK_TOKEN)].rstrip()
        if text and text[0].islower():
            text = text[0].upper() + text[1:]
        if text and text[-1] not in ".!?":
            text += "."
        allowed_extra = _LANG_EXTRA.get(self.language, "") + "áéíóúàèìòùâêîôûäëïöüñç"
        text = "".join(c for c in text if ord(c) < 127 or c in allowed_extra)
        # (delta: the reference leaves a double space where a filtered char
        # was; collapse it)
        return re.sub(r" {2,}", " ", text).strip()
