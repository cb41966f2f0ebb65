"""Minimal RAKE (Rapid Automatic Keyword Extraction), the port's own copy of
``vtc_tpu/data/rake.py`` (standard library only).

The reference summarizes >77-token texts by extracting RAKE keyword phrases
before re-tokenizing (``dataset_loaders/dataset_loaders.py:224-248``, via
``rake_nltk``). Neither rake_nltk nor NLTK's stopword data is a dependency,
so this is a dependency-free implementation of the published RAKE algorithm (Rose et
al. 2010): split text into candidate phrases at stopwords/punctuation, score
each word by degree/frequency, rank phrases by the sum of member word scores.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import List

# Compact English stopword list (standard SMART-style function words).
STOPWORDS = frozenset(
    """a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for from
further had hadn't has hasn't have haven't having he he'd he'll he's her here
here's hers herself him himself his how how's i i'd i'll i'm i've if in into
is isn't it it's its itself let's me more most mustn't my myself no nor not of
off on once only or other ought our ours ourselves out over own same shan't
she she'd she'll she's should shouldn't so some such than that that's the
their theirs them themselves then there there's these they they'd they'll
they're they've this those through to too under until up very was wasn't we
we'd we'll we're we've were weren't what what's when when's where where's
which while who who's whom why why's with won't would wouldn't you you'd
you'll you're you've your yours yourself yourselves""".split()
)

_WORD_SPLIT = re.compile(r"[^a-zA-Z0-9_\+\-/]")
_SENT_SPLIT = re.compile(r"[.!?,;:\t\"\(\)\[\]\n']|\s[-–—]\s")


def _split_words(text: str) -> List[str]:
    return [w.strip().lower() for w in _WORD_SPLIT.split(text) if w.strip()]


def _candidate_phrases(text: str) -> List[List[str]]:
    phrases = []
    for sentence in _SENT_SPLIT.split(text):
        current: List[str] = []
        for word in _split_words(sentence):
            if word in STOPWORDS or word.isdigit():
                if current:
                    phrases.append(current)
                    current = []
            else:
                current.append(word)
        if current:
            phrases.append(current)
    return phrases


class Rake:
    """API-compatible subset of ``rake_nltk.Rake`` used by the reference."""

    def __init__(self, max_phrase_words: int = 100):
        self.max_phrase_words = max_phrase_words
        self._ranked: List[str] = []

    def extract_keywords_from_text(self, text: str) -> None:
        phrases = [
            p for p in _candidate_phrases(text) if len(p) <= self.max_phrase_words
        ]
        freq: dict = defaultdict(int)
        degree: dict = defaultdict(int)
        for phrase in phrases:
            for word in phrase:
                freq[word] += 1
                degree[word] += len(phrase) - 1
        scores = {w: (degree[w] + freq[w]) / freq[w] for w in freq}

        phrase_scores = [
            (sum(scores[w] for w in phrase), " ".join(phrase)) for phrase in phrases
        ]
        phrase_scores.sort(key=lambda x: (-x[0], x[1]))
        seen = set()
        ranked = []
        for _, phrase in phrase_scores:
            if phrase not in seen:
                seen.add(phrase)
                ranked.append(phrase)
        self._ranked = ranked

    def get_ranked_phrases(self) -> List[str]:
        return list(self._ranked)
