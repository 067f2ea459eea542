"""The PyTorch port's HTML tokenizer against the JAX package's: the port
builds its element tree with `text/dom.py` (the standard library's
html.parser, libxml2's recovery rules) where the JAX package calls
`lxml.html.fromstring`. Trees, tokens, links, summaries and parsed pages
must be equal, exactly, on the seeded test pages, bench.py's pages, the
cases of tests/test_text.py, the decoding and recovery traps below, and a
generator of random nested pages."""

from __future__ import annotations

import random

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from lxml import etree
from lxml import html as lxml_html

import test_text
from corpus import make_page
from spaghettisearch_tpu.text import htmlparse as jhp
from spaghettisearch_tpu.text.page import parse_page as jparse
from spaghettisearch_tpu_torch.corpus import render_pages
from spaghettisearch_tpu_torch.text import dom
from spaghettisearch_tpu_torch.text import htmlparse as thp
from spaghettisearch_tpu_torch.text.page import parse_page as tparse

torch.set_num_threads(1)

BASE = "http://site.local/dir/page.html"


def _lxml_tree(el):
    if not isinstance(el.tag, str):
        assert el.tag is etree.Comment, el.tag
        return ("#comment", (), el.text, el.tail, ())
    return (el.tag, tuple(el.attrib.items()), el.text, el.tail,
            tuple(_lxml_tree(c) for c in el))


def _dom_tree(el):
    if not isinstance(el.tag, str):
        assert el.tag is dom.Comment
        return ("#comment", (), el.text, el.tail, ())
    return (el.tag, tuple(el.attrib.items()), el.text, el.tail,
            tuple(_dom_tree(c) for c in el))


def _trees(raw: bytes):
    try:
        want = _lxml_tree(lxml_html.fromstring(raw))
    except etree.ParserError:
        want = "ParserError"
    try:
        got = _dom_tree(dom.fromstring(raw))
    except dom.ParserError:
        got = "ParserError"
    return got, want


def assert_same_page(raw: bytes, base: str = BASE) -> None:
    """Element tree, tokenize_page (every field), extract_summary_text and
    parse_page all equal to the JAX package's."""
    got, want = _trees(raw)
    assert got == want
    for summary in (False, True):
        assert thp.tokenize_page(raw, base, summary).__dict__ == \
            jhp.tokenize_page(raw, base, summary).__dict__
    assert thp.extract_summary_text(raw) == jhp.extract_summary_text(raw)
    t, j = tparse(raw, base), jparse(raw, base)
    assert (t.title_text, t.title.__dict__, t.body.__dict__, t.clean_fancy, t.links) == \
        (j.title_text, j.title.__dict__, j.body.__dict__, j.clean_fancy, j.links)
    assert {k: v.__dict__ for k, v in t.fancy.items()} == \
        {k: v.__dict__ for k, v in j.fancy.items()}
    assert t.raw.__dict__ == j.raw.__dict__


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_corpus_pages(seed):
    rng = random.Random(seed)
    for i in range(40):
        url, html = make_page(rng, i, 40, "http://test.local")
        assert_same_page(html, url)


@pytest.mark.parametrize("seed", [0, 3])
def test_bench_pages(seed):
    pages = render_pages(n_pages=150, n_vocab=2000, seed=seed)
    for path, html in pages.items():
        assert_same_page(html, "http://bench.local" + path)


TEXT_CASES = [
    test_text.HTML,
    b"",
    b"   \n",
    b"<p>unclosed <b>bold",
    b"<html><head><title>  Department of Computing </title></head></html>",
]

# the traps: decoding, fragment wrapping, node shapes, recovery
TRAP_CASES = {
    "latin1_default": "<p>café</p>".encode(),
    "meta_charset": '<meta charset="utf-8"><p>café</p>'.encode(),
    "http_equiv": b'<html><head><meta http-equiv="Content-Type" content="text/html; '
                  b'charset=utf-8"></head><body>caf\xc3\xa9</body></html>',
    "http_equiv_after_title": b'<html><head><title>caf\xc3\xa9</title><meta http-equiv='
                              b'"Content-Type" content="text/html; charset=utf-8"></head>'
                              b"<body>caf\xc3\xa9</body></html>",
    "meta_after_text": b"<html><body>caf\xc3\xa9<meta charset=\"utf-8\">caf\xc3\xa9</body></html>",
    "windows_1252": b'<html><head><meta http-equiv="Content-Type" content="text/html; '
                    b'charset=windows-1252"></head><body>\x93q\x94</body></html>',
    "shift_jis": b'<html><head><meta charset="shift_jis"></head><body>\x82\xa0</body></html>',
    "unknown_charset": b'<meta charset="bogus"><p>caf\xc3\xa9</p>',
    "empty_charset": b'<meta charset=""><p>caf\xc3\xa9 x</p><p>y\xff</p>z',
    "bom": b"\xef\xbb\xbf<html><body>caf\xc3\xa9</body></html>",
    "utf8_tag_name": b"<div>x<caf\xc3\xa9>y</caf\xc3\xa9>z</div>",
    "latin1_tag_name": b"<div>x<caf\xe9 a=1>y</caf\xe9>z</div>",
    "fragment_div": b"<p>one<p>two<div>three</div>",
    "fragment_span": b"hello <b>x</b> tail",
    "fragment_one": b"<p>only</p>",
    "comment_tail": b"<div>a<!-- c --> d<br>e&nbsp;f<img src=x>g</div>",
    "comments_only": b"<!-- only -->",
    "void_tails": b"<p>a<br>b<meta name=description content=x>c<img>d<hr>e</p>",
    "entities": b"<p>&amp; &lt; &copy &copy; &nbsp; &#233; &#x41; &#1; &notin; &notit;</p>",
    "attr_entities": b'<a href="/x?a=1&copy=2&amp;b=&lt;">t</a>',
    "script_style": b"<script>if (a<b) {}</script><style>p{}</style><p>x",
    "script_escape": b"<script><!--<script>x</script>y</script>z",
    "misnested": b"<b><i>x</b>y</i>z",
    "table": b"<table><tr><td>a<td>b</table>after",
    "lists": b"<ul><li>a<li>b</ul>",
    "after_html": b"<html><body><p>a</body></html>tail",
    "title_in_body": b"<title>T</title><p>x",
    "two_bodies": b"<body><p>a</p></body><body class=x><p>b</p></body>",
    "doctype": b"<!DOCTYPE html><html><head></head><body><p>x</p></body></html>",
    "pi_cdata": b"<p>a<?php echo 1 ?>b<![CDATA[c]]>d</p>",
    "eof_in_tag": b'<p>x</p><a href="/y',
    "eof_in_comment": b"<p>x</p><!-- open",
    "cr_nul": b"<p>a\r\nb\rc\x00d</p>",
    "nested_a": b'<a href="/1">one<a href="/2">two</a></a>',
    "frameset": b"<frameset><frame src=x></frameset><p>y",
    "boolean_attrs": b"<form><input checked name=x><select multiple><option selected>o"
                     b"</select><td nowrap foo>x</form>",
    "utf32_bom": "<p>café</p>".encode("utf-32"),
    "utf32_be": "<html><body>café</body></html>".encode("utf-32-be"),
    "utf16_xml_decl": '<?xml version="1.0"?><p>café</p>'.encode("utf-16-le"),
    "utf16_no_bom": "<p>x</p>".encode("utf-16-le"),
    "depth_253": b"<html><body>" + b"<div>" * 253 + b"x<i>y</i>z" + b"</div>" * 253 + b"<p>after",
    "depth_254": b"<html><body>" + b"<div>" * 254 + b"x<i>y</i>z" + b"</div>" * 254 + b"<p>after",
    "depth_void": b"<body>" + b"<div>" * 254 + b"<br>x" + b"</div>" * 254 + b"<p>after",
    "depth_unclosed": b"<font>" * 400 + b"deep<p>after" + b"<b><i>" * 300 + b"end",
}


@pytest.mark.parametrize("raw", TEXT_CASES, ids=[f"text{i}" for i in range(len(TEXT_CASES))])
def test_text_cases(raw):
    assert_same_page(raw)


@pytest.mark.parametrize("name", sorted(TRAP_CASES))
def test_traps(name):
    assert_same_page(TRAP_CASES[name])


def test_trap_values():
    """The issue's examples, spelled out."""
    assert dom.fromstring("<p>café</p>".encode()).text == "cafÃ©"
    root = dom.fromstring('<meta charset="utf-8"><p>café</p>'.encode())
    assert [el.text for el in root.iter() if el.tag == "p"] == ["café"]
    root = dom.fromstring(b"<p>one<p>two<div>three</div>")
    assert root.tag == "div" and [c.tag for c in root] == ["p", "p", "div"]
    assert dom.fromstring(b"hello <b>x</b> tail").tag == "span"
    root = dom.fromstring(b"<div>a<!-- c --> d<br>e&nbsp;f</div>")
    assert root[0].tag is dom.Comment and root[0].tail == " d"
    assert root[1].tag == "br" and len(root[1]) == 0 and root[1].tail == "e\xa0f"


def _raw_text_page(tag: str) -> bytes:
    """A non-ASCII byte right after '<' inside a raw-text element: libxml2
    reads it (it is text, not a tag name), so it settles on Latin-1 there
    and a later <meta> charset does not count."""
    t = tag.encode()
    return b"<p>x</p><" + t + b"><caf\xc3\xa9</" + t + b"><meta charset=utf-8><p>\xc3\xa9</p>"


# Once known differences from libxml2 (ROADMAP Queue 3), now equal: the
# first non-ASCII byte libxml2 reads in raw text (every element lxml treats
# as raw text), and libxml2's limits: a text run over 10,000,000 bytes is
# dropped and parsing stops there; a tag or attribute name keeps its first
# 100 bytes (so one over 50,000 bytes does too).
KNOWN = {
    "raw_text_tag_name": b"<p>x</p><style><caf\xc3\xa9</style><meta charset=utf-8><p>\xc3\xa9</p>",
    **{f"raw_text_{tag}": _raw_text_page(tag) for tag in (
        "script", "style", "xmp", "iframe", "noembed", "noframes", "title", "textarea",
        "plaintext",
    )},
    # outside raw text the same bytes are a tag name, kept undecoded (UTF-8)
    # though a later <meta> settles the encoding
    **{f"name_before_meta_{tag}": _raw_text_page(tag) for tag in ("p", "noscript", "pre")},
    "name_before_meta_cp1252": _raw_text_page("p").replace(b"utf-8", b"windows-1252"),
    "limit_text_over_10mb":b"<html><body><p>x<b>y</b>" + b"a" * 10_000_010
                            + b"</p><!-- c --><p>after</p></body></html>",
    "limit_name_over_50000": b"<p>x<" + b"a" * 50_001 + b" " + b"k" * 50_001 + b"=v k"
                             + b"k" * 130 + b"=w>y</" + b"a" * 50_001 + b">z</p>",
}


@pytest.mark.parametrize("name", sorted(KNOWN))
def test_known_differences_pinned(name):
    assert_same_page(KNOWN[name])


_TAGS = ("html head body title meta p div span a b i u em ul ol li table tr td th "
         "tbody h1 h4 br img hr script style noscript iframe nav form input option "
         "textarea pre font center dl dt dd small caption frameset xmp").split()
_ATTRS = ("href", "name", "content", "class", "id", "src", "HREF")
_TEXT = ("hello", "world", " ", "\n", "café", "&amp;", "&nbsp;", "&copy", "&lt;x", "a&b",
         "<", ">", "&#233;", "&#x41;", "x\r\ny", "  two  words ", "中", "&notin;", '"', "/",
         "<!-- c -->", "<!-->", "<?pi x?>", "<![CDATA[z]]>", "</ >", "&#1;")
_VALUES = ('"v"', "'w x'", "u", '"/p1"', '"a&amp;b"', '""', '"utf-8"')
_BARE = ("checked", "selected", "nowrap", "href", "foo")  # attributes without a value


@st.composite
def _pages(draw):
    rng = random.Random(draw(st.integers(0, 2**32 - 1)))

    def gen(depth: int) -> str:
        out = []
        for _ in range(rng.randint(0, 5)):
            r = rng.random()
            if r < 0.35:
                out.append(rng.choice(_TEXT))
            elif r < 0.45:
                out.append("</" + rng.choice(_TAGS) + ">")
            else:
                t = rng.choice(_TAGS)
                t = t.upper() if rng.random() < 0.2 else t
                pool = ("http-equiv", "charset", "content", "name") if t.lower() == "meta" else _ATTRS
                attrs = "".join(
                    f" {rng.choice(pool)}={rng.choice(_VALUES)}" if rng.random() < 0.8
                    else f" {rng.choice(_BARE)}" for _ in range(rng.randint(0, 2))
                )
                out.append(f"<{t}{attrs}{'/' if rng.random() < 0.05 else ''}>")
                if depth < 4:
                    out.append(gen(depth + 1))
                if rng.random() < 0.7:
                    out.append(f"</{t}>")
        return "".join(out)

    page = gen(0)
    if rng.random() < 0.5:
        page = f"<html><head><title>{rng.choice(_TEXT)}</title></head><body>{page}</body></html>"
    if rng.random() < 0.2:
        page = page[: rng.randint(0, len(page))]
    return page.encode(rng.choice(["utf-8", "latin-1"]), "replace")


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(_pages())
def test_random_nested_pages(raw):
    assert_same_page(raw)
