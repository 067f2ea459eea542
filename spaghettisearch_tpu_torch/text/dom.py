"""A small HTML element tree that parses pages the way lxml does, without lxml.

The JAX package parses pages with `lxml.html.fromstring`, that is libxml2's
HTML parser (2.14: an HTML5 tokenizer in front of libxml2's own tree
construction) followed by lxml's fragment wrapping. A GPU host has no lxml,
so this module builds the same tree with the standard library alone, on a
copy of `html.parser`'s main loop:

- decoding (`_decode`): a byte-order mark wins. Otherwise
  libxml2 reads the bytes undecoded up to the first non-ASCII byte outside
  a tag name; a `<meta charset>` or `<meta http-equiv="Content-Type"
  content="...charset=NAME">` naming a known encoding before it decodes
  the bytes after that tag (an empty name: UTF-8 up to the first invalid
  byte, where the page ends). Failing that, at that byte libxml2 searches
  the rest of the page for HTTP-EQUIV, CONTENT and CHARSET=NAME in turn
  (htmlFindEncoding) and decodes from there with NAME (UTF-8 if unknown),
  else as Latin-1; names read before that point keep their bytes, so are
  UTF-8. CR LF and lone CR become LF, NUL becomes U+FFFD;
- tokenizing (`_Tokenizer`): html.parser's main loop, copied as CPython
  3.12.12 has it and depending on none of its internals, so that the tree
  does not change with the interpreter's patch release, with libxml2's raw-text elements (script, style, xmp,
  iframe, noembed, noframes, plaintext) and escapable raw-text elements
  (title, textarea); attributes are re-read from the raw start tag so
  that character references in them follow HTML5's attribute rule
  (`&copy=` stays as it is); numeric references to controls and
  noncharacters keep them (`unescape`); the first of two equal attribute
  names wins; processing instructions, CDATA sections and bogus comments
  become comments, doctypes are dropped;
- tree construction (`_Assembler`): libxml2's recovery rules. A start tag
  first closes the open elements it ends (`_CLOSED_BY`, libxml2's
  htmlStartClose), then implies html, head or body as libxml2's
  htmlCheckImplied does; misplaced html, head and body start tags are
  dropped together with their end tags; an end tag closes the elements
  above its own unless one of them ranks higher (`_PRIORITY`); void
  elements and `<x/>` close at once; non-blank text directly in html or
  head implies a body; adjacent text merges; once the root element is
  closed, or an element would open past depth 256, nothing more enters
  the tree;
- fragments (`fromstring`): lxml.html.fromstring's wrapping of a page that
  does not start with `<html` or `<!doctype` (a lone element, or the body
  renamed div or span).

The tables were read off lxml 6.1 with libxml2 2.14.6; tests/test_torch_text.py
holds them, and the whole parse, against lxml.
"""

from __future__ import annotations

import codecs
import html
import re
from html.entities import html5 as _HTML5


class ParserError(ValueError):
    """The page holds no element (lxml's etree.ParserError)."""


class _CommentTag:
    def __repr__(self) -> str:
        return "Comment"


#: the tag of comment nodes; like lxml's etree.Comment, it is not a str
Comment = _CommentTag()


class Element:
    """One node of the tree: tag, attributes, text (before the first child),
    tail (after the node's end, up to the next sibling), children. Comments
    are nodes too, whose tag is `Comment` and whose tail belongs to the
    parent's text."""

    __slots__ = ("tag", "attrib", "text", "tail", "children", "parent")

    def __init__(self, tag, attrib: dict | None = None) -> None:
        self.tag = tag
        self.attrib = attrib if attrib is not None else {}
        self.text: str | None = None
        self.tail: str | None = None
        self.children: list[Element] = []
        self.parent: Element | None = None

    def __iter__(self):
        return iter(self.children)

    def __len__(self) -> int:
        return len(self.children)

    def __getitem__(self, i):
        return self.children[i]

    def __repr__(self) -> str:
        return f"<Element {self.tag}>"

    def get(self, key: str, default=None):
        return self.attrib.get(key, default)

    def append(self, child: "Element") -> None:
        child.parent = self
        self.children.append(child)

    def iter(self):
        """This element and every element below it, in document order
        (comments left out)."""
        stack = [self]
        while stack:
            el = stack.pop()
            if isinstance(el.tag, str):
                yield el
                stack.extend(reversed(el.children))

    def getroot(self) -> "Element":
        """The document's root element (what an XPath `//` searches)."""
        el = self
        while el.parent is not None:
            el = el.parent
        return el


# --- libxml2's tables -------------------------------------------------------

#: elements with no content (libxml2's HTML 4 empty elements)
_VOID = frozenset(
    "area base basefont br col frame hr img input isindex link meta param".split()
)
#: raw text: nothing inside is markup or a character reference
_RAW = ("script", "style", "xmp", "iframe", "noembed", "noframes")
#: escapable raw text: character references are decoded
_RCDATA = ("title", "textarea")
#: a start tag of one of these, with only html open, implies a head
_HEAD_TAGS = frozenset(("script", "style", "meta", "link", "title", "base"))
#: end-tag ranks (htmlEndPriority): a misplaced end tag closes no element
#: that ranks higher than itself; the rest rank 100
_PRIORITY = {
    "div": 150, "td": 160, "th": 160, "tr": 170, "thead": 180, "tbody": 180,
    "tfoot": 180, "table": 190, "head": 200, "body": 200, "html": 220,
}
_H = ("fieldset", "form", "li", "p", "table")
#: open element -> the start tags that close it (htmlStartClose)
_CLOSED_BY = {k: frozenset(v.split()) for k, v in {
    "a": "a fieldset table td th",
    "address": "dd dl dt form li ul",
    "b": "center p td th",
    "big": "p",
    "caption": "col colgroup tbody tfoot thead tr",
    "colgroup": "colgroup tbody tfoot thead tr",
    "dd": "dt",
    "dir": "dd dl dt form ul",
    "dl": "form li",
    "dt": "dd dl",
    "font": "center td th",
    "form": "form",
    "h1": " ".join(_H), "h2": " ".join(_H), "h3": " ".join(_H),
    "h4": " ".join(_H), "h5": " ".join(_H), "h6": " ".join(_H),
    "head": "a abbr acronym address b bdo big blockquote body br center cite code dd "
            "dfn dir div dl dt em fieldset font form frameset h1 h2 h3 h4 h5 h6 "
            "hr i iframe img kbd li listing map menu ol p pre q s samp small span "
            "strike strong sub sup table tt u ul var xmp",
    "i": "center p td th",
    "legend": "fieldset",
    "li": "li",
    "listing": "dd dl dt fieldset form li table ul",
    "menu": "dd dl dt form ul",
    "ol": "form",
    "option": "optgroup option",
    "p": "address blockquote body caption center col colgroup dd dir div dl dt "
         "fieldset form frameset h1 h2 h3 h4 h5 h6 head hr li listing menu ol p "
         "pre table tbody td tfoot th title tr ul xmp",
    "pre": "dd dl dt fieldset form li table ul",
    "s": "p",
    "small": "p",
    "span": "td th",
    "strike": "p",
    "tbody": "tbody tfoot",
    "td": "tbody td tfoot th tr",
    "tfoot": "tbody",
    "th": "tbody td tfoot th tr",
    "thead": "tbody tfoot",
    "tr": "tbody tfoot tr",
    "tt": "p",
    "u": "p td th",
    "ul": "address form menu pre",
}.items()}
_NO_CLOSE: frozenset = frozenset()
#: lxml.html.defs.block_tags: a fragment body holding one of these becomes a div
_BLOCK_TAGS = frozenset(
    "address blockquote caption center col colgroup dd del dir div dl dt fieldset "
    "form h1 h2 h3 h4 h5 h6 hr ins isindex legend li menu noscript ol optgroup "
    "option p pre table tbody td tfoot th thead tr ul".split()
)
_BLANK = " \t\n\r\x0c"
#: libxml2's parser depth limit (without XML_PARSE_HUGE): html is depth 1
_MAX_DEPTH = 256
#: libxml2 keeps a tag or attribute name's first 100 bytes (UTF-8, whole
#: characters)
_NAME_MAX = 100
#: a text, raw-text or comment run over this many bytes (UTF-8) is dropped
#: and parsing stops (libxml2's XML_MAX_TEXT_LENGTH, without XML_PARSE_HUGE)
_TEXT_MAX = 10_000_000


class _Assembler:
    """libxml2's tree construction over the tokenizer's events."""

    def __init__(self) -> None:
        self.root: Element | None = None
        self.stack: list[Element] = []  # open elements, innermost last
        self.level = 0  # libxml2's ctxt->html: 3 once a head opened, 10 once a body did
        self.depth = 0  # misplaced html/head/body start tags whose end tags are dropped
        self.done = False  # the root closed: nothing more enters the tree

    def _open(self, tag: str, attrib: dict) -> None:
        el = Element(tag, attrib)
        if self.stack:
            self.stack[-1].append(el)
        else:
            self.root = el
        self.stack.append(el)
        if tag == "head" and self.level < 3:
            self.level = 3
        elif tag == "body" and self.level < 10:
            self.level = 10

    def _pop(self) -> None:
        self.stack.pop()
        if not self.stack:
            self.done = True

    def _auto_close(self, tag: str) -> None:
        stack = self.stack
        while stack and tag in _CLOSED_BY.get(stack[-1].tag, _NO_CLOSE):
            self._pop()

    def implied(self, tag: str) -> None:
        if not self.done:
            self._implied(tag)

    def _implied(self, tag: str) -> None:
        if tag == "html":
            return
        if not self.stack:
            self._open("html", {})
        if tag in ("body", "head"):
            return
        if len(self.stack) <= 1 and tag in _HEAD_TAGS:
            if self.level < 3:
                self._open("head", {})
        elif tag not in ("noframes", "frame", "frameset"):
            if self.level >= 10 or any(el.tag in ("body", "head") for el in self.stack):
                return
            self._open("body", {})

    def start(self, tag: str, attrib: dict, closed: bool = False, dropped: bool = False) -> None:
        """A start tag; `dropped`: one the page ends inside of, which closes
        and implies elements but makes none."""
        if self.done:
            return
        self._auto_close(tag)
        self._implied(tag)
        if dropped:
            return
        if (
            (tag == "html" and self.stack)
            or (tag == "head" and len(self.stack) != 1)
            or (tag == "body" and any(el.tag == "body" for el in self.stack))
        ):
            self.depth += 1
            if closed and self.stack:
                self._pop()  # libxml2 ends the current element for the '/>'
            return
        if len(self.stack) >= _MAX_DEPTH:
            self.done = True  # libxml2's "Excessive depth": it stops parsing
            return
        self._open(tag, attrib)
        if closed or tag in _VOID:
            self._pop()

    def end(self, tag: str) -> None:
        if self.done:
            return
        if self.depth > 0 and tag in ("html", "body", "head"):
            self.depth -= 1
            return
        stack = self.stack
        rank = _PRIORITY.get(tag, 100)
        for el in reversed(stack):
            if el.tag == tag:
                break
            if _PRIORITY.get(el.tag, 100) > rank:
                return
        else:
            return  # not open: dropped
        while stack[-1].tag != tag:
            self._pop()
        self._pop()

    def data(self, text: str) -> None:
        if self.done or not text:
            return
        body = text.lstrip(_BLANK)
        if body and len(body) < len(text):
            # libxml2 hands a text run's leading blanks over on their own
            self.data(text[: len(text) - len(body)])
            text = body
            if self.done:
                return
        if body:
            if not self.stack or self.stack[-1].tag in ("html", "head"):
                self._auto_close("p")
                self._implied("p")
        elif not self.stack:
            return  # blanks before the root
        el = self.stack[-1]
        if el.children:
            last = el.children[-1]
            last.tail = text if last.tail is None else last.tail + text
        else:
            el.text = text if el.text is None else el.text + text

    def comment(self, text: str) -> None:
        if self.done or not self.stack:
            return  # outside the root element's tree
        node = Element(Comment)
        node.text = text
        self.stack[-1].append(node)


# --- tokenizing -------------------------------------------------------------

_SKIP = re.compile(r"[\t\n\f\r /]*")  # before an attribute name
_NAME = re.compile(r"[^\t\n\f\r />][^\t\n\f\r /=>]*")  # attribute name
_TAG = re.compile(r"[^\t\n\f\r />]*")  # the rest of a tag name
_EQ = re.compile(r"[\t\n\f\r ]*=[\t\n\f\r ]*")
_UNQUOTED = re.compile(r"[^\t\n\f\r >]*")
_COMMENT_END = re.compile(r"--!?>")
_ABRUPT = re.compile(r"-?>")  # '<!-->' and '<!--->' are empty comments
_LOWER = str.maketrans("ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")
_CHARREF = re.compile(r"&(#[0-9]+;?|#[xX][0-9a-fA-F]+;?|[^\t\n\f <&#;]{1,32};?)")


def _numeric_ref(ref: str) -> str:
    """A numeric character reference as libxml2 reads it: html.unescape's
    result, except that the code points HTML5 calls invalid (controls,
    noncharacters), which html.unescape drops, stay as they are."""
    out = html.unescape(ref)
    if out:
        return out
    digits = ref[2:].rstrip(";")
    return chr(int(digits[1:], 16) if digits[:1] in ("x", "X") else int(digits))


def _text_ref(m: re.Match) -> str:
    if m.group(1)[0] == "#":
        return _numeric_ref(m.group(0))
    return html.unescape(m.group(0))


def unescape(text: str) -> str:
    """Character references in text as libxml2 decodes them."""
    return _CHARREF.sub(_text_ref, text) if "&" in text else text


def _attr_ref(m: re.Match) -> str:
    s = m.group(1)
    if s[0] == "#":
        return _numeric_ref(m.group(0))
    if s in _HTML5:
        return html.unescape(m.group(0))
    # a legacy name without ';' is a reference only when neither an ASCII
    # letter or digit nor '=' follows it (HTML5, character references in
    # attribute values)
    for x in range(len(s) - 1, 1, -1):
        if s[:x] in _HTML5:
            if s[x] == "=" or (s[x].isascii() and s[x].isalnum()):
                return m.group(0)
            return _HTML5[s[:x]] + s[x:]
    return m.group(0)


def _scan_tag(s: str, i: int):
    """HTML5's tag states over s from the tag name at i (after '<' or '</').
    -> (end after '>', lower-cased name, attributes, self-closing), or None
    when the page ends inside the tag. Attribute names are lower-cased, the
    first of two equal names is kept, values are unescaped."""
    j = _TAG.match(s, i + 1).end()
    name = s[i:j].translate(_LOWER)  # ASCII letters only, as HTML5
    attrib: dict[str, str] = {}
    n = len(s)
    while True:
        k = _SKIP.match(s, j).end()
        if k >= n:
            return None
        if s[k] == ">":
            return k + 1, name, attrib, k > j and s[k - 1] == "/"
        j = _NAME.match(s, k).end()
        key = s[k:j].translate(_LOWER)
        value = key if key in _BOOLEAN_ATTRS else ""  # a name without '='
        eq = _EQ.match(s, j)
        if eq is not None:
            j = eq.end()
            if j >= n:
                return None
            q = s[j]
            if q == '"' or q == "'":
                close = s.find(q, j + 1)
                if close < 0:
                    return None
                value, j = s[j + 1 : close], close + 1
            else:
                j = _UNQUOTED.match(s, j).end()
                value = s[eq.end() : j]
            if "&" in value:
                value = _CHARREF.sub(_attr_ref, value)
        attrib.setdefault(key, value)


#: libxml2's boolean attributes: written without a value, their value is
#: their name (other attributes without a value get "")
_BOOLEAN_ATTRS = frozenset(
    "checked compact declare defer disabled ismap multiple nohref noresize noshade "
    "nowrap readonly selected".split()
)
_STARTTAG_OPEN = re.compile("<[a-zA-Z]")
_ENDTAG_OPEN = re.compile("</[a-zA-Z]")
_AMP_END = re.compile(r"[\t\n\r\f ;]")
_END_TAGS: dict[str, re.Pattern] = {}
_SCRIPT_MARKS = re.compile(r"<!--|-->|<(/?)script(?=[\t\n\f\r />])", re.I)


def _end_tag(name: str) -> re.Pattern:
    pat = _END_TAGS.get(name)
    if pat is None:
        pat = _END_TAGS[name] = re.compile(r"</%s(?=[\t\n\f\r />])" % name, re.I)
    return pat


def _script_end(s: str, i: int) -> int:
    """Where the `</script` that ends a script's text from i starts (the
    page's end if none does), through HTML5's script data states: after
    `<!--` a `<script` starts a nested one whose `</script` does not end the
    element, and `-->` leaves both."""
    escaped = nested = False
    pos = i
    while True:
        m = _SCRIPT_MARKS.search(s, pos)
        if m is None:
            return len(s)
        pos = m.end()
        mark = m.group()
        if mark == "<!--":
            if not escaped:
                j = pos
                while s[j : j + 1] == "-":
                    j += 1
                escaped = s[j : j + 1] != ">"  # '<!-->' escapes nothing
            else:
                pos = m.start() + 2  # its dashes may close the escape ('<!--->')
        elif mark == "-->":
            escaped = nested = False
        elif m.group(1):  # </script
            if not nested:
                return m.start()
            nested = False
        elif escaped:  # <script
            nested = True


def _utf8(name: str) -> str:
    raw = b"".join(c.encode("latin-1" if c <= "\xff" else "utf-8") for c in name)
    return raw.decode("utf-8", "replace")


def _cut(name: str) -> str:
    """A name as libxml2 keeps it: its longest prefix of at most _NAME_MAX
    bytes in UTF-8."""
    if len(name) <= _NAME_MAX // 4:
        return name
    return name.encode("utf-8")[:_NAME_MAX].decode("utf-8", "ignore")


def _huge(text: str) -> bool:
    """A run libxml2 drops, stopping there: over _TEXT_MAX bytes in UTF-8."""
    return len(text) > _TEXT_MAX // 4 and len(text.encode("utf-8")) > _TEXT_MAX


class _Tokenizer:
    """html.parser's tokenizer feeding an _Assembler. Tags, comments and raw
    text are read here (HTML5's states): tags by `_scan_tag`, the text of
    libxml2's raw-text elements up to their end tag (title and textarea
    unescaped, a script by `_script_end`). `feed` the page, then `close`."""

    def __init__(self, asm: _Assembler, utf8_before: int = 0) -> None:
        self.asm = asm
        self.at_end = False
        self.rawdata = ""  # the characters fed and not yet tokenized
        self.size = 0  # characters fed
        self.utf8_before = utf8_before

    def feed(self, data: str) -> None:
        self.size += len(data)
        self.rawdata += data
        self.goahead(False)

    def _names(self, i: int, name: str, attrib: dict) -> tuple[str, dict]:
        """Names as libxml2 reads them: it takes a name's bytes as they
        are, so the non-ASCII names of a tag at i that comes before
        `utf8_before` (bytes not yet decoded, see `_decode`) are UTF-8.
        Every name is cut to _NAME_MAX bytes (`_cut`); of two attributes
        whose names then agree, the first is kept."""
        if self.size - len(self.rawdata) + i < self.utf8_before:
            if not name.isascii():
                name = _utf8(name)
            if not all(k.isascii() for k in attrib):
                fixed: dict[str, str] = {}
                for k, v in attrib.items():
                    fixed.setdefault(k if k.isascii() else _utf8(k), v)
                attrib = fixed
        name = _cut(name)
        if any(len(k) > _NAME_MAX // 4 for k in attrib):
            cut: dict[str, str] = {}
            for k, v in attrib.items():
                cut.setdefault(_cut(k), v)
            attrib = cut
        return name, attrib

    def _run(self, text: str) -> bool:
        """False, and the tree ends, if libxml2 drops the run (`_huge`)."""
        if _huge(text):
            self.asm.done = True
            return False
        return True

    def close(self) -> None:
        self.at_end = True
        self.goahead(True)

    def parse_starttag(self, i: int) -> int:
        rawdata = self.rawdata
        tag = _scan_tag(rawdata, i + 1)
        if tag is None:
            if self.at_end:  # the page ends inside a start tag: libxml2
                name = rawdata[i + 1 : _TAG.match(rawdata, i + 2).end()]
                name = self._names(i, name.translate(_LOWER), {})[0]
                self.asm.start(name, {}, dropped=True)
            return -1
        end, name, attrib, closed = tag
        name, attrib = self._names(i, name, attrib)
        self.asm.start(name, attrib, closed)
        if closed or not (name in _RAW or name in _RCDATA or name == "plaintext"):
            return end
        # raw text up to the element's end tag (the whole page is fed at once)
        if name == "plaintext":
            stop = len(rawdata)
        elif name == "script":
            stop = _script_end(rawdata, end)
        else:
            m = _end_tag(name).search(rawdata, end)
            stop = len(rawdata) if m is None else m.start()
        text = rawdata[end:stop]
        if text and self._run(text):
            self.asm.data(unescape(text) if name in _RCDATA else text)
        if stop == len(rawdata):
            return stop
        tag = _scan_tag(rawdata, stop + 2)
        if tag is None:
            return len(rawdata)  # the page ends inside the end tag
        self.asm.end(name)
        return tag[0]

    def parse_endtag(self, i: int) -> int:
        rawdata = self.rawdata
        c = rawdata[i + 2 : i + 3]
        if not (c.isascii() and c.isalpha()):
            if c == ">":
                return i + 3  # '</>' is dropped
            end = rawdata.find(">", i + 2)  # a bogus comment
            if end < 0:
                return -1
            self.handle_comment(rawdata[i + 2 : end])
            return end + 1
        tag = _scan_tag(rawdata, i + 2)
        if tag is None:
            return -1
        self.asm.end(self._names(i, tag[1], {})[0])
        return tag[0]

    def parse_comment(self, i: int) -> int:
        rawdata = self.rawdata
        m = _ABRUPT.match(rawdata, i + 4)
        if m is not None:
            self.handle_comment("")
            return m.end()
        m = _COMMENT_END.search(rawdata, i + 4)
        if m is None:
            return -1
        text = rawdata[i + 4 : m.start()]
        if self._run(text):
            self.handle_comment(text)
        return m.end()

    def parse_html_declaration(self, i: int) -> int:
        rawdata = self.rawdata
        if rawdata.startswith("<![", i):  # a bogus comment up to '>'
            end = rawdata.find(">", i + 3)
            if end < 0:
                return -1
            self.handle_comment(rawdata[i + 2 : end])
            return end + 1
        if rawdata[i : i + 9].lower() == "<!doctype":
            end = rawdata.find(">", i + 9)
            if end < 0:
                return -1
            self.handle_decl(rawdata[i + 2 : end])
            return end + 1
        return self.parse_bogus_comment(i)

    def parse_bogus_comment(self, i: int) -> int:
        end = self.rawdata.find(">", i + 2)
        if end < 0:
            return -1
        self.handle_comment(self.rawdata[i + 2 : end])
        return end + 1

    def parse_pi(self, i: int) -> int:
        end = self.rawdata.find(">", i + 2)
        if end < 0:
            return -1
        self.handle_pi(self.rawdata[i + 2 : end])
        return end + 1

    def goahead(self, end: bool) -> None:
        """html.parser's main loop (as CPython 3.12.12 has it, with
        convert_charrefs and no CDATA mode: raw text is read by
        parse_starttag), kept here so that the tree does not change with
        the interpreter's patch release."""
        rawdata = self.rawdata
        i, n = 0, len(rawdata)
        startswith = rawdata.startswith
        while i < n:
            j = rawdata.find("<", i)
            if j < 0:
                # a character reference may be cut at the end of the data
                amp = rawdata.rfind("&", max(i, n - 34))
                if amp >= 0 and not _AMP_END.search(rawdata, amp):
                    break
                j = n
            if i < j and self._run(rawdata[i:j]):
                self.handle_data(unescape(rawdata[i:j]))
            i = j
            if i == n:
                break
            if _STARTTAG_OPEN.match(rawdata, i):
                k = self.parse_starttag(i)
            elif startswith("</", i):
                k = self.parse_endtag(i)
            elif startswith("<!--", i):
                k = self.parse_comment(i)
            elif startswith("<?", i):
                k = self.parse_pi(i)
            elif startswith("<!", i):
                k = self.parse_html_declaration(i)
            elif i + 1 < n or end:
                self.handle_data("<")
                k = i + 1
            else:
                break
            if k < 0:
                if not end:
                    break
                k = n  # the page ends inside this construct
                if _STARTTAG_OPEN.match(rawdata, i):
                    pass
                elif startswith("</", i):
                    if i + 2 == n:
                        self.handle_data("</")
                    elif not _ENDTAG_OPEN.match(rawdata, i):
                        self.handle_comment(rawdata[i + 2 :])
                elif startswith("<!--", i):
                    stop = n
                    for suffix in ("--!", "--", "-"):
                        if rawdata.endswith(suffix, i + 4):
                            stop -= len(suffix)
                            break
                    self.handle_comment(rawdata[i + 4 : stop])
                elif startswith("<![CDATA[", i):
                    self.unknown_decl(rawdata[i + 3 :])
                elif rawdata[i : i + 9].lower() == "<!doctype":
                    self.handle_decl(rawdata[i + 2 :])
                elif startswith("<!", i):
                    self.handle_comment(rawdata[i + 2 :])
                else:  # '<?'
                    self.handle_pi(rawdata[i + 2 :])
            i = k
        if end and i < n:
            if self._run(rawdata[i:n]):
                self.handle_data(unescape(rawdata[i:n]))
            i = n
        self.rawdata = rawdata[i:]

    def handle_data(self, data) -> None:
        if data == "<":
            # a '<' that opens no tag implies a body as a start tag would
            # (it matters only under a frameset, where nothing else does)
            self.asm.implied("p")
        self.asm.data(data)

    def handle_comment(self, data) -> None:
        self.asm.comment(data)

    def handle_pi(self, data) -> None:
        self.asm.comment("?" + data)

    def unknown_decl(self, data) -> None:
        self.asm.comment("[" + data)  # '<![CDATA[' at the page's end

    def handle_decl(self, decl) -> None:
        pass  # a doctype makes no node of the element tree


# --- decoding ---------------------------------------------------------------

_NON_ASCII = re.compile(rb"[\x80-\xff]")
_META = re.compile(rb"<meta", re.I)
_CHARSET_NAME = re.compile(r"[A-Za-z0-9][A-Za-z0-9._:-]*\Z")
_CHARSET = re.compile(r"charset", re.I)


#: an empty declared charset: UTF-8 up to the first byte that is not, where
#: libxml2 stops parsing
_UTF8_UNTIL_ERROR = "utf-8 until error"


def _codec(name: str) -> str | None:
    """Python's codec for an encoding name libxml2 would accept, or None."""
    if not name:
        return _UTF8_UNTIL_ERROR
    if not _CHARSET_NAME.match(name):
        return None
    try:
        info = codecs.lookup(name)
    except LookupError:
        return None
    return info.name if getattr(info, "_is_text_encoding", True) else None


def _meta_charset(attrib: dict) -> str | None:
    """The codec a <meta> start tag declares (libxml2's htmlCheckMeta)."""
    http, content = False, None
    for name, value in attrib.items():
        if name == "http-equiv" and value.lower() == "content-type":
            http = True
        elif name == "charset":
            codec = _codec(value)
            if codec is not None:
                return codec
        elif name == "content":
            content = value
    if http and content is not None:
        m = _CHARSET.search(content)
        if m is None:
            return None
        rest = content[m.end():]
        if rest[:1] in _BLANK and rest[:1]:
            rest = content[content.find("="):] if "=" in content else ""
        if rest[:1] == "=":
            return _codec(rest[1:])
    return None


class _Declared(Exception):
    def __init__(self, end: int, codec: str) -> None:
        self.end, self.codec = end, codec


class _MetaScan(_Tokenizer):
    """Finds the first <meta> start tag that declares a known encoding."""

    def __init__(self) -> None:
        super().__init__(_Assembler())

    def parse_starttag(self, i: int) -> int:
        tag = _scan_tag(self.rawdata, i + 1)
        if tag is not None and tag[1] == "meta":
            codec = _meta_charset(tag[2])
            if codec is not None:  # rawdata holds the text's last characters
                raise _Declared(self.size - len(self.rawdata) + tag[0], codec)
        return super().parse_starttag(i)


def _decode(raw: bytes) -> tuple[str, int]:
    """A page's bytes as libxml2 decodes them -> (the text, the offset in it
    before which names are UTF-8). Without a byte-order mark, libxml2 reads
    the bytes undecoded up
    to the first non-ASCII byte outside a tag name; a <meta> before it can
    declare the encoding. Else, at that byte, it searches the rest of the
    page for HTTP-EQUIV, then CONTENT, then CHARSET=NAME, anywhere and in
    any case (htmlFindEncoding), and decodes from there with NAME (UTF-8
    if NAME is unknown), or as Latin-1 if the search fails. Names read
    before that point keep their bytes, so are UTF-8."""
    head4 = raw[:4]
    if head4 in _UTF32:  # libxml2 detects these from the first four bytes
        bom = 4 if b"\xfe" in head4 else 0
        text, utf8_before = raw[bom:].decode(_UTF32[head4], "replace"), 0
    elif head4 in _UTF16:
        text, utf8_before = raw.decode(_UTF16[head4], "replace"), 0
    elif raw.startswith(b"\xef\xbb\xbf"):
        text, utf8_before = raw[3:].decode("utf-8", "replace"), 0
    elif raw.startswith((b"\xff\xfe", b"\xfe\xff")):
        text, utf8_before = raw.decode("utf-16", "replace"), 0
    elif raw.startswith(b"<?xm"):  # an XML declaration's first bytes: UTF-8
        text, utf8_before = raw.decode("utf-8", "replace"), 0
    else:
        n = _first_read_non_ascii(raw)
        codec, end = None, n
        metas = list(_META.finditer(raw, 0, n))
        if metas:
            # the tokenizer sees every tag before the last <meta> whole
            prefix = raw[: min(n, metas[-1].start() + 4096)].decode("latin-1")
            scan = _MetaScan()
            try:
                scan.feed(prefix)
                scan.close()
            except _Declared as found:
                codec, end = found.codec, found.end
        if codec is None and n < len(raw):
            name = _find_encoding(raw, n)
            codec = "latin-1" if name is None else _codec(name) or "utf-8"
        if codec is None:
            tail = ""
        elif codec == _UTF8_UNTIL_ERROR:
            rest = raw[end:]
            try:
                tail = rest.decode("utf-8")
            except UnicodeDecodeError as e:
                tail = rest[: e.start].decode("utf-8")
        else:
            tail = raw[end:].decode(codec, "replace")
        head = raw[:end].decode("latin-1")
        utf8_before = len(_newlines(head))
        text = head + tail
    return _newlines(text), utf8_before


def _newlines(text: str) -> str:
    """CR LF and lone CR become LF, NUL becomes U+FFFD."""
    if "\r" in text:
        text = text.replace("\r\n", "\n").replace("\r", "\n")
    if "\x00" in text:
        text = text.replace("\x00", "\ufffd")
    return text


_UTF32 = {b"\x00\x00\xfe\xff": "utf-32-be", b"\xff\xfe\x00\x00": "utf-32-le",
          b"\x00\x00\x00<": "utf-32-be", b"<\x00\x00\x00": "utf-32-le"}
_UTF16 = {b"<\x00?\x00": "utf-16-le", b"\x00<\x00?": "utf-16-be"}  # '<?' without a BOM
_NON_ASCII_STR = re.compile(r"[\x80-\xff]")
_FIND_WORDS = [re.compile(w, re.I) for w in (rb"HTTP-EQUIV", rb"CONTENT", rb"CHARSET=")]
_FOUND_NAME = re.compile(rb"[A-Za-z0-9_:/-]*")


def _find_encoding(raw: bytes, i: int) -> str | None:
    """libxml2's htmlFindEncoding from byte i: the first HTTP-EQUIV, the
    first CONTENT after it, the first CHARSET= after that, and the name
    right after it; None if any of them is missing or the name empty."""
    for word in _FIND_WORDS:
        m = word.search(raw, i)
        if m is None:
            return None
        i = m.end()
    name = _FOUND_NAME.match(raw, i).group()
    return name.decode("ascii") or None


def _first_read_non_ascii(raw: bytes) -> int:
    """The first non-ASCII byte that is not part of a tag name, with the
    tags found as the tokenizer finds them: the text of a raw-text element
    (script, style, title, ...), comments and attribute values are read."""
    if _NON_ASCII.search(raw) is None:
        return len(raw)
    s = raw.decode("latin-1")
    n = len(s)

    def read_from(i: int, stop: int = n) -> int | None:
        m = _NON_ASCII_STR.search(s, i, stop)
        return None if m is None else m.start()

    def tag(lt: int, name_at: int) -> tuple[int | None, int, tuple | None]:
        """A start or end tag at lt: -> (the first read non-ASCII in it or
        None, where it ends, _scan_tag's result)."""
        name_end = _TAG.match(s, name_at + 1).end()
        found = _scan_tag(s, name_at)
        end = n if found is None else found[0]
        return read_from(name_end, end), end, found

    pos = 0
    while True:
        first = read_from(pos)
        if first is None:
            return n
        lt = s.find("<", pos, first)
        if lt < 0:
            return first
        if _STARTTAG_OPEN.match(s, lt):
            hit, end, found = tag(lt, lt + 1)
            if hit is not None or found is None:
                return n if hit is None else hit
            _, name, _, closed = found
            pos = end
            if closed or not (name in _RAW or name in _RCDATA or name == "plaintext"):
                continue
            if name == "plaintext":
                stop = n
            elif name == "script":
                stop = _script_end(s, end)
            else:
                m = _end_tag(name).search(s, end)
                stop = n if m is None else m.start()
            hit = read_from(end, stop)
            if hit is not None or stop == n:
                return n if hit is None else hit
            hit, pos, found = tag(stop, stop + 2)
            if hit is not None or found is None:
                return n if hit is None else hit
        elif s.startswith("</", lt) and s[lt + 2 : lt + 3].isascii() and s[lt + 2 : lt + 3].isalpha():
            hit, pos, found = tag(lt, lt + 2)
            if hit is not None or found is None:
                return n if hit is None else hit
        else:
            # a comment, a declaration, a processing instruction or a lone
            # '<': read up to its end
            if s.startswith("<!--", lt):
                m = _ABRUPT.match(s, lt + 4) or _COMMENT_END.search(s, lt + 4)
                end = n if m is None else m.end()
            elif s.startswith(("<!", "<?", "</"), lt):
                end = s.find(">", lt + 2)
                end = n if end < 0 else end + 1
            else:
                end = lt + 1
            if first < end:
                return first
            pos = end


# --- lxml.html.fromstring -----------------------------------------------------

_FULL_HTML = re.compile(rb"^\s*<(?:html|!doctype)", re.I)


def parse_document(raw: bytes) -> Element | None:
    """The root element of the page's document tree (None if it has none)."""
    asm = _Assembler()
    text, utf8_before = _decode(raw)
    tok = _Tokenizer(asm, utf8_before)
    tok.feed(text)
    tok.close()
    return asm.root


def _drop_tree(el: Element) -> None:
    """Remove el and its subtree; its tail joins the previous sibling's
    tail or the parent's text (lxml's drop_tree)."""
    parent = el.parent
    i = parent.children.index(el)
    if el.tail:
        if i > 0:
            prev = parent.children[i - 1]
            prev.tail = (prev.tail or "") + el.tail
        else:
            parent.text = (parent.text or "") + el.tail
    del parent.children[i]
    el.parent = None


def _move_children(dst: Element, src: Element) -> None:
    for child in src.children:
        dst.append(child)
    src.children = []


def fromstring(raw: bytes) -> Element:
    """lxml.html.fromstring on bytes: the document root for a page that
    starts with <html or <!doctype; otherwise the one element of the body,
    or the body renamed div (if it holds a block element) or span."""
    doc = parse_document(raw)
    if doc is None:
        raise ParserError("Document is empty")
    if _FULL_HTML.match(raw):
        return doc
    bodies = [el for el in doc if el.tag == "body"]
    body = bodies[0] if bodies else None
    for other in bodies[1:]:
        if other.text:
            if len(body):
                body[-1].tail = (body[-1].tail or "") + other.text
            else:
                body.text = (body.text or "") + other.text
        _move_children(body, other)
        _drop_tree(other)
    heads = [el for el in doc if el.tag == "head"]
    if heads:
        for other in heads[1:]:
            _move_children(heads[0], other)
            _drop_tree(other)
        return doc
    if body is None:
        return doc
    if (
        len(body) == 1
        and (not body.text or not body.text.strip())
        and (not body[-1].tail or not body[-1].tail.strip())
    ):
        return body[0]
    body.tag = "div" if any(el.tag in _BLOCK_TAGS for el in body.iter()) else "span"
    return body
