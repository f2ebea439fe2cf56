"""Text inputs made from the seed: the vocabulary, web-search queries and
the pages of the WARC files.

Every English word comes from words.txt (common English words) or
STOPWORDS, and each is one token of the vocabulary, which holds no `##`
pieces: so any run of letters or digits is one token (a word, or [UNK])
and every punctuation mark another. `token_count` counts by that rule,
and tests/test_bench_reference.py holds it to the frozen WordPiece.

The English prose recipe (a third stopwords) and the vocab layouts are
those of chip_smoke.py's swarm_corpus, _bert_vocab and _mpnet_layout.
The page mix (languages, text lengths, HTML sizes) is a traffic file's
data; `Pages` documents what each parameter is.
"""

from __future__ import annotations

import os
import re
import string

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STOPWORDS = ("the", "of", "and", "a", "to", "in", "is", "was", "it", "for",
             "on", "that", "with", "as", "by", "at", "from", "this", "are")
BERT_SPECIALS = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                 + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
MAX_TITLE, MAX_TEXT = 200, 2048   # the node's caps (ingest/pages.py)
_RUN = re.compile(r"[A-Za-z0-9]+|[^\sA-Za-z0-9]")


def words() -> list[str]:
    with open(os.path.join(HERE, "words.txt"), encoding="utf-8") as f:
        return [w for w in f.read().split() if w not in STOPWORDS]


def bert_vocab(size: int) -> list[str]:
    """BERT-uncased layout of `size` lines: [PAD], [unused0-98], [UNK],
    [CLS], [SEP], [MASK], the ASCII punctuation, digits and letters, the
    words, then [unusedN] filler."""
    singles = [c for c in string.punctuation + string.digits
               + string.ascii_lowercase]
    body = list(dict.fromkeys(BERT_SPECIALS + singles + list(STOPWORDS)
                              + words()))
    if len(body) > size:
        raise ValueError(f"{len(body)} tokens do not fit a vocab of {size}")
    return body + [f"[unused{i}]" for i in range(99, 99 + size - len(body))]


def vocab_for(config: dict) -> list[str]:
    """The vocab of a configuration's family at its published size: BERT's
    layout, or all-mpnet-base-v2's (<s> <pad> </s> <unk>, a whole BERT
    vocab, <mask> last)."""
    size = config["vocab_size"]
    if config["model_type"] == "mpnet":
        return ["<s>", "<pad>", "</s>", "<unk>", *bert_vocab(size - 5),
                "<mask>"]
    return bert_vocab(size)


def token_count(text: str) -> int:
    """Tokens of `text` without [CLS] / [SEP] under this vocabulary."""
    return len(_RUN.findall(text))


def combined_tokens(title: str, text: str, max_len: int = 512) -> int:
    """Tokens the node encodes for a page, [CLS] and [SEP] included."""
    return min(max_len, token_count(title) + token_count(text) + 2)


def query_pool(rng: np.random.Generator, n: int, length_share: list,
               stop_share: float = 0.15) -> list[str]:
    """n distinct queries; length_share[m - 1] is the share of m-word
    queries. The lengths are one fixed multiset for every seed (the
    quantiles of that law), dealt out in seeded order; the one-word
    queries are distinct content words."""
    cdf = np.cumsum(length_share) / np.sum(length_share)
    lengths = 1 + np.searchsorted(cdf, (np.arange(n) + 0.5) / n)
    lengths = rng.permutation(lengths)
    vocab = np.array(words())
    stop = np.array(STOPWORDS)
    singles = iter(rng.choice(vocab, int((lengths == 1).sum()),
                              replace=False))
    out, seen = [], set()
    for m in lengths:
        if m == 1:
            q = str(next(singles))
        else:
            while True:
                w = np.where(rng.random(m) < stop_share,
                             rng.choice(stop, m), rng.choice(vocab, m))
                w[0] = rng.choice(vocab)  # queries open with a content word
                q = " ".join(w)
                if q not in seen:
                    break
        seen.add(q)
        out.append(q)
    return out


def zipf_ranks(rng: np.random.Generator, n: int, pool: int,
               exponent: float) -> np.ndarray:
    """n ranks in [0, pool): one fixed multiset (the quantiles of a Zipf
    law of `exponent` over `pool` ranks) in seeded order."""
    w = np.arange(1, pool + 1, dtype=np.float64) ** -exponent
    cdf = np.cumsum(w) / w.sum()
    ranks = np.searchsorted(cdf, (np.arange(n) + 0.5) / n)
    return rng.permutation(np.minimum(ranks, pool - 1))


def poisson_due(rng: np.random.Generator, n: int, rate: float) -> np.ndarray:
    """Due times (s) of n Poisson arrivals at `rate`: the gaps are one
    fixed multiset (the exponential's quantiles) in seeded order."""
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    return np.cumsum(rng.permutation(gaps)) - gaps.mean()


LANGUAGES = ("en", "latin", "cyrillic", "cjk", "other")
MIN_CLEAN_TEXT = 400  # the node drops a page whose text is shorter
SITES = 97
FILL = 4096  # fillers come in multiples of this many characters
_HEAD_JOIN = "</style><script>"
# Function words of other Latin-script languages (German, Spanish, French,
# Italian, Portuguese, Dutch, Polish), none of them a stopword of the
# node's English filter, and syllables that make their other words.
_LATIN_FUNCTION = (
    "de la que el en los del se las por un una con para es al lo como pero "
    "sus le les des et du est pas pour qui dans une sur ne par der die und "
    "den von zu das mit sich auf für ist im dem nicht ein eine als auch het "
    "een van dat niet il di che per non sono da ma em os uma não na się nie "
    "do jest że").split()
_LATIN_SYLLABLES = ("ber gen schaft ción men ierung ção lich keit tion dad "
                    "ità ung ent ver zio ame ó é ü ñ ç ã ß ers ach ita ado "
                    "ere ist ind wą ży rz cz sz ał").split()
# Code point ranges of the other scripts' letters.
_SCRIPTS = {"cyrillic": [(0x0430, 0x0450)],
            "cjk": [(0x4E00, 0x9FA6), (0x3041, 0x3094)],
            "other": [(0x0627, 0x064B), (0x0915, 0x093A), (0x0E01, 0x0E2F),
                      (0x03B1, 0x03CA), (0x05D0, 0x05EB)]}


def _lognormal_quantiles(n: int, mean: float, sigma: float) -> np.ndarray:
    """The n quantiles at (k + 0.5) / n of the lognormal law of that mean
    and sigma: one fixed multiset for every seed."""
    from statistics import NormalDist
    inv = NormalDist().inv_cdf
    z = np.fromiter((inv((k + 0.5) / n) for k in range(n)), np.float64, n)
    return np.exp(np.log(mean) - sigma * sigma / 2 + sigma * z)


def _units(rng: np.random.Generator, words: list[str]) -> tuple[str, str]:
    """A stylesheet and a script of about 12 KB each, which pages repeat
    as their inline <style> and <script> (no '<' in either)."""
    css, js = [], []
    while sum(map(len, css)) < 12_000:
        a, b, c = rng.integers(0, 400, 3)
        w = words[int(rng.integers(0, len(words)))]
        css.append(f".{w}-{a} .wp-block-{w}__inner{{margin:{b}px 0 {c}px;"
                   f"padding:{a % 17}px {b % 23}px;color:#{a:03x}{b % 256:02x}"
                   f";font-size:{1 + c / 400:.3f}rem;line-height:1.{c % 9}}}"
                   f"@media (max-width:{600 + a}px){{.{w}-{a}{{display:none}}}}")
    while sum(map(len, js)) < 12_000:
        a, b = rng.integers(0, 10_000, 2)
        w = words[int(rng.integers(0, len(words)))]
        js.append(f"window.{w}{a}=function(e,t){{var n=e.length;for(var r=0;"
                  f"r!==n;r++){{if(e[r].id==={b})return t.push(e[r]),"
                  f"\"{w}\"}}return null}};document.addEventListener("
                  f"\"DOMContentLoaded\",function(){{window.dataLayer="
                  f"window.dataLayer||[];dataLayer.push({{\"event\":\"{w}\","
                  f"\"id\":{a},\"v\":{b}}})}});")
    return "".join(css), "".join(js)


class Pages:
    """The WARC corpus: page i has a unique URL, a language, a title, a
    visible text and an HTML document of a set size, each made from the
    seed. Every law is one fixed multiset dealt out in seeded order.

    - `languages`: the share of pages in each of LANGUAGES. English pages
      carry words.txt prose (chip_smoke.py's swarm_corpus recipe: a
      sentence no other page has, then the page's own `topic` content
      words, a third stopwords). The others carry function words and
      accented syllables of Latin-script languages, or letters of
      Cyrillic, CJK or another script; the node's English filter drops
      every one of them.
    - `text_mean_chars`, `text_sigma`: the visible text's length, a
      lognormal law clipped to [100, 12,000] characters. A shorter text
      than MIN_CLEAN_TEXT is dropped by the node.
    - `html_mean_bytes`, `html_sigma`, `html_max_bytes`: the HTML
      document's size, a lognormal law capped at `html_max_bytes`. The
      document is a site's template (head with meta and link tags,
      header and menu, breadcrumbs, cookie notice, sidebar, footer, an
      SVG icon), the text in paragraphs, headings and lists with inline
      links and emphasis, a related-posts list and share links, and
      inline <style> and <script> up to the size (the script mostly after
      the content, so the content lies inside the first 250,000 bytes
      the node reads). The node's extractor keeps exactly the text:
      every other block is boilerplate, link-dense or under 20
      characters.
    """

    def __init__(self, seed: int, n: int, languages: dict,
                 text_mean_chars: float, text_sigma: float,
                 html_mean_bytes: float, html_sigma: float,
                 html_max_bytes: int, topic: int = 12):
        rng = np.random.default_rng([seed, 7])
        self.seed, self.n, self.topic = seed, n, topic
        self.vocab = np.array(words())
        m = 1 << 20  # symbols < topic: a topic word; others: a stopword
        self.stream = np.where(rng.random(m) < 1 / 3,
                               topic + rng.integers(0, len(STOPWORDS), m),
                               rng.integers(0, topic, m))
        self.max_chars = 12_000
        self.lengths = rng.permutation(np.clip(_lognormal_quantiles(
            n, text_mean_chars, text_sigma), 100, self.max_chars)
        ).astype(int)
        self.sizes = rng.permutation(np.minimum(_lognormal_quantiles(
            n, html_mean_bytes, html_sigma), html_max_bytes)).astype(int)
        share = np.array([languages.get(k, 0.0) for k in LANGUAGES], float)
        counts = np.floor(share / share.sum() * n).astype(int)
        counts[0] += n - counts.sum()
        self.lang = rng.permutation(np.repeat(np.arange(len(LANGUAGES)),
                                              counts))
        self.starts = rng.integers(0, m - self.max_chars, n)
        self._stream = self.stream.tolist()
        self._vocab, self._stop = self.vocab.tolist(), list(STOPWORDS)
        self.topics = rng.integers(0, len(self.vocab), (n, topic))
        self.names = rng.choice(self.vocab, (n, 4))
        self.html_max = html_max_bytes
        css, js = _units(np.random.default_rng([seed, 8]), self._vocab)
        self._css = css * (html_max_bytes // len(css) + 1)
        self._js = js * (html_max_bytes // len(js) + 1)
        syl = np.random.default_rng([seed, 9])
        self._latin = _LATIN_FUNCTION + [
            "".join(syl.choice(_LATIN_SYLLABLES, int(k)))
            for k in syl.integers(2, 4, 400)]
        self._sites: dict[int, tuple[str, str, str]] = {}

    # -- what the node keeps ---------------------------------------------

    def language(self, i: int) -> str:
        return LANGUAGES[int(self.lang[i])]

    def kept(self) -> np.ndarray:
        """Whether the node indexes page i, for every i: English, with a
        text of MIN_CLEAN_TEXT characters or more."""
        en = self.lang == 0
        keep = en & (self.lengths >= MIN_CLEAN_TEXT + 50)
        for i in np.flatnonzero(en & (self.lengths >= MIN_CLEAN_TEXT - 50)
                                & (self.lengths < MIN_CLEAN_TEXT + 50)):
            keep[i] = len(self.text(int(i))) >= MIN_CLEAN_TEXT
        return keep

    def url(self, i: int) -> str:
        return f"https://site{i % SITES}.example/{self.names[i, 1]}/{i}"

    def title(self, i: int) -> str:
        if self.lang[i]:
            return self._foreign(i, 24 + i % 40, tag=1)
        w = self.names[i]
        return f"{w[3]} {w[0]} {i}"

    def text(self, i: int) -> str:
        if self.lang[i]:
            return self._foreign(i, int(self.lengths[i]), tag=2)
        w = self.names[i]
        head = (f"Page {i} tells of the {w[0]} and the {w[1]} near the "
                f"{w[2]} {w[3]}. ")
        want = int(self.lengths[i]) - len(head)
        s = int(self.starts[i])
        table = [self._vocab[t] for t in self.topics[i]] + self._stop
        body = " ".join([table[k] for k in self._stream[s: s + want // 4 + 8]])
        body = body[:max(want, 100)]
        return head + body.rsplit(" ", 1)[0] + "."

    def stored(self, i: int) -> tuple[str, str, str]:
        """(url, title, text) as the node keeps page i."""
        return (self.url(i), self.title(i)[:MAX_TITLE],
                " ".join(self.text(i).split())[:MAX_TEXT])

    @staticmethod
    def index_of(url: str) -> int:
        return int(url.rsplit("/", 1)[1])

    # -- the other languages ---------------------------------------------

    def _foreign(self, i: int, chars: int, tag: int) -> str:
        rng = np.random.default_rng([self.seed, 10 + tag, i])
        lang = self.language(i)
        if lang == "latin":
            words = [self._latin[k] for k in
                     rng.integers(0, len(self._latin), chars // 5 + 2)]
            return " ".join(words)[:chars].rsplit(" ", 1)[0] + "."
        ranges = _SCRIPTS[lang]
        lo, hi = ranges[int(rng.integers(0, len(ranges)))]
        codes = rng.integers(lo, hi, chars).astype(np.uint32)
        codes[rng.random(chars) < (0.08 if lang == "cjk" else 0.17)] = 0x20
        return codes.tobytes().decode("utf-32-le")

    # -- the document ----------------------------------------------------

    def _site(self, s: int) -> tuple[str, str, str]:
        """Site s's template, in the three pieces that every page of the
        site shares: head tags; header and menu; sidebar, footer and
        cookie notice."""
        if s in self._sites:
            return self._sites[s]
        rng = np.random.default_rng([self.seed, 14, s])
        v = self._vocab
        pick = lambda k: [v[j] for j in rng.integers(0, len(v), k)]  # noqa: E731
        host = f"https://site{s}.example"
        head = "".join(
            [f'<meta name="viewport" content="width=device-width, '
             f'initial-scale=1"><meta name="robots" content="index, follow, '
             f'max-image-preview:large"><meta property="og:site_name" '
             f'content="Site {s}"><meta name="generator" '
             f'content="WordPress 6.4.{s % 4}">']
            + [f'<link rel="stylesheet" id="{w}-css" href="{host}/wp-content/'
               f'plugins/{w}/assets/css/{w}.min.css?ver=3.{k}.1" '
               f'media="all">' for k, w in enumerate(pick(12 + s % 10))]
            + [f'<link rel="preload" href="{host}/wp-content/themes/t{s}/'
               f'fonts/{w}.woff2" as="font" type="font/woff2" crossorigin>'
               for w in pick(4)]
            + [f'<script src="{host}/wp-includes/js/{w}.min.js?ver=3.7.1" '
               f'id="{w}-js"></script>' for w in pick(6 + s % 6)])
        menu = "".join(
            f'<li id="menu-item-{k}" class="menu-item menu-item-type-taxonomy'
            f'"><a href="{host}/category/{w}/">{w.title()}</a><ul class="sub-'
            f'menu">' + "".join(f'<li class="menu-item"><a href="{host}/'
                                f'{w}/{u}/">{u.title()}</a></li>'
                                for u in pick(3)) + "</ul></li>"
            for k, w in enumerate(pick(12 + s % 24)))
        header = (
            f'<a class="skip-link screen-reader-text" href="#content">Skip to '
            f'content</a><header id="masthead" class="site-header"><div '
            f'class="site-branding"><p class="site-title"><a href="{host}/" '
            f'rel="home">Site {s}</a></p><p class="site-description">News '
            f'and stories about {" and ".join(pick(2))}</p></div><nav '
            f'id="site-navigation" class="main-navigation"><button '
            f'class="menu-toggle" aria-expanded="false">Menu</button><svg '
            f'class="icon" width="24" height="24" viewBox="0 0 24 24"><path '
            f'd="M4 6h16v2H4zm0 5h16v2H4zm0 5h16v2H4z"></path></svg><ul '
            f'id="primary-menu" class="menu">{menu}</ul></nav></header>')
        widgets = "".join(
            f'<section class="widget widget_recent_entries"><h2 class="widget-'
            f'title">{w.title()}</h2><ul>' + "".join(
                f'<li><a href="{host}/{u}/">{u.title()} and the {w} of the '
                f'{u}</a></li>' for u in pick(5)) + "</ul></section>"
            for w in pick(3 + s % 3))
        aside = (
            f'<aside id="secondary" class="widget-area"><section class="widget'
            f' widget_search"><form role="search" method="get" action="{host}'
            f'/"><label>Search for:<input type="search" name="s"></label>'
            f'<button type="submit">Search</button></form></section>'
            f'<section class="widget widget_text"><div class="textwidget"><p>'
            f'Site {s} writes about the {" and the ".join(pick(3))} for its '
            f'readers every week, and has done so for many years.</p></div>'
            f'</section>{widgets}</aside>')
        footer = (
            f'<footer id="colophon" class="site-footer"><div class="footer-'
            f'widgets"><ul>' + "".join(f'<li><a href="{host}/{w}/">{w.title()}'
                                       f'</a></li>' for w in pick(16))
            + f'</ul></div><div class="site-info">Copyright 2024 Site {s}. All'
            f' rights reserved. Proudly powered by WordPress.</div></footer>'
            f'<div id="cookie-notice" role="dialog"><form method="post"><p>We '
            f'use cookies on this website to give you the most relevant '
            f'experience by remembering your preferences.</p><button '
            f'type="submit">Accept all</button><button>Reject</button></form>'
            f'</div>')
        self._sites[s] = (
            head + "<style>",
            '</script></head><body class="post-template-default single '
            f'single-post">{header}<div id="content" class="site-content">',
            f"{aside}</div>{footer}<script>")
        return self._sites[s]

    def _content(self, i: int, text: str, rng) -> str:
        """The text as blocks of 24 characters or more (paragraphs, some
        headings, list items and quotes), which the node joins with
        single spaces; inline links and emphasis, in blocks of 20 words or
        more, cover at most a fifth of a block's words."""
        w = text.split(" ")
        n = len(w)
        r = rng.random(n)
        blocks: list[list] = []  # [tag, words]
        k = 0
        while k < n:
            u = float(r[k])
            tag, m = (("h2", 4 + int(u * 1e4) % 5) if u < 0.06 else
                      ("li", 12 + int(u * 1e4) % 16) if u < 0.16 else
                      ("blockquote", 40 + int(u * 1e4) % 40) if u < 0.20
                      else ("p", 60 + int(u * 1e4) % 80))
            seg = w[k:k + m]
            k += m
            if n - k < 6:  # fold a short tail into this block
                seg += w[k:]
                k = n
            if blocks and (len(" ".join(seg)) < 24
                           or len(" ".join(blocks[-1][1])) < 24):
                blocks[-1][1] += seg
            else:
                blocks.append([tag, seg])
        host = f"https://site{i % SITES}.example"
        html = []
        for tag, seg in blocks:
            words = list(seg)
            last = -2
            for j in np.flatnonzero(rng.random(len(seg) - 1) < 0.04)[
                    :len(seg) // 10].tolist():
                if j <= last + 1:
                    continue
                last = j
                if j % 3 == 0:
                    words[j] = f'<a href="{host}/{seg[j]}/">{seg[j]}'
                    words[j + 1] += "</a>"
                else:
                    tag_ = "strong" if j % 3 == 1 else "em"
                    words[j] = f"<{tag_}>{seg[j]}"
                    words[j + 1] += f"</{tag_}>"
            body = " ".join(words)
            html.append(
                f'<ul class="wp-block-list"><li>{body}</li></ul>'
                if tag == "li" else
                f'<blockquote class="wp-block-quote"><p>{body}</p>'
                f'</blockquote>' if tag == "blockquote" else
                f'<h2 class="wp-block-heading">{body}</h2>' if tag == "h2"
                else f"<p>{body}</p>")
        return "\n".join(html)

    def parts(self, i: int) -> list:
        """Page i's HTML as a list of str pieces and fillers: tuples that
        `filler` expands, the pieces that pages share."""
        rng = np.random.default_rng([self.seed, 15, i])
        s = i % SITES
        host = f"https://site{s}.example"
        title = self.title(i)
        lang = ("en", "de", "ru", "zh", "ar")[int(self.lang[i])]
        content = self._content(i, self.text(i), rng)
        related = "".join(f'<li><a href="{host}/{w}/">The {w} and the '
                          f'{w} of the year</a></li>'
                          for w in rng.choice(self.vocab, 4))
        top = (f'<!DOCTYPE html><html lang="{lang}"><head><meta charset="UTF-'
               f'8"><title>{title}</title><meta name="description" content="'
               f'{title}"><link rel="canonical" href="{self.url(i)}">')
        mid = (f'<nav class="breadcrumbs"><a href="{host}/">Home</a> &raquo; '
               f'{title}</nav><main id="main" class="site-main"><article id="'
               f'post-{i}" class="post type-post status-publish"><header '
               f'class="entry-header"><h1 class="entry-title">{title}</h1><div'
               f' class="entry-meta">Posted on <time>June {1 + i % 28}, 2023'
               f'</time> by <a href="{host}/author/">admin</a></div></header>'
               f'<div class="entry-content">\n{content}\n</div><div class="'
               f'sharedaddy"><a href="#">Facebook</a> <a href="#">X</a> <a '
               f'href="#">Email</a> <a href="#">Print</a></div><div class="'
               f'related-posts"><h3>Related</h3><ul>{related}</ul></div>'
               f'</article></main>')
        tail = (f'</script><script type="application/ld+json">{{"@context":'
                f'"https://schema.org","@type":"Article","url":"{self.url(i)}'
                f'","datePublished":"2023-06-{1 + i % 28:02d}"}}</script>'
                f'</body></html>')
        have = (len(top) + len(mid) + len(tail) + len(_HEAD_JOIN)
                + sum(map(len, self._site(s))))
        if self.lang[i]:  # count the bytes of the other scripts' letters
            have += (len(content.encode()) - len(content)
                     + 4 * (len(title.encode()) - len(title)))
        left = max(0, int(self.sizes[i]) - have) // FILL
        style = min(left // 4, 60_000 // FILL)
        pre = min(left // 7, 40_000 // FILL)
        post = left - style - pre
        return [top, ("site", s, 0), ("head", style * FILL, pre * FILL),
                ("site", s, 1), mid, ("site", s, 2), ("js", post * FILL),
                tail]

    def filler(self, kind: str, n: int, m: int = 0) -> str:
        """A piece that pages share: ("site", s, k) is site s's k-th
        template piece; ("head", n, m) is n characters of stylesheet, the
        style's end and a script's start, and m characters of script;
        ("js", n) is n characters of script."""
        if kind == "site":
            return self._site(n)[m]
        if kind == "head":
            return self._css[:n] + _HEAD_JOIN + self._js[:m]
        return self._js[:n]

    def filler_len(self, kind: str, n: int, m: int = 0) -> int:
        """The bytes of a filler (all ASCII)."""
        if kind == "site":
            return len(self._site(n)[m])
        return n + m + (len(_HEAD_JOIN) if kind == "head" else 0)

    def html(self, i: int) -> str:
        return "".join(p if isinstance(p, str) else self.filler(*p)
                       for p in self.parts(i))
