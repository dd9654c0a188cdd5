"""Static HTML model-comparison report.

Feature parity with internal/utils/utils.go:23-214: one card per cluster with
the label list, a model-comparison table (service / title / catchy phrase /
download button), a client-side JSON download of
{title, catchyPhrase, images, labels}, and an image grid served from
``/api/image/{name}``. Written as plain Python templating with strict HTML /
JS escaping (the reference leans on Go html/template plus a hand-rolled
escapeJS, utils.go:217-226).
"""

from __future__ import annotations

import html
import json
import os

from imageclust_tpu_torch.types import ClusterDetails

__all__ = ["render_report", "write_report"]

_PAGE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="UTF-8">
<title>Model Comparison - Clustered Images</title>
<style>
  body {{ font-family: system-ui, sans-serif; background: #f1f3f5; margin: 0; }}
  .container {{ width: 95%; margin: auto; padding: 20px; }}
  .cluster {{ border: 1px solid #ccc; padding: 20px; margin-bottom: 30px;
             border-radius: 8px; background: #fff; }}
  .cluster h2 {{ margin-top: 0; color: #2c3e50; }}
  .comparison-table {{ width: 100%; border-collapse: collapse; margin: 20px 0; }}
  .comparison-table th {{ background: #f8f9fa; padding: 12px; text-align: left;
                         border-bottom: 2px solid #dee2e6; color: #2c3e50; }}
  .comparison-table td {{ padding: 12px; border-bottom: 1px solid #dee2e6;
                         vertical-align: top; }}
  .comparison-table tr:hover {{ background-color: #f8f9fa; }}
  .image-container {{ display: flex; flex-wrap: wrap; gap: 15px; margin-top: 20px; }}
  .image {{ text-align: center; flex: 0 0 200px; }}
  .image img {{ max-width: 200px; height: auto; border-radius: 4px; }}
  .download-button {{ background-color: #4CAF50; color: white; padding: 8px 16px;
                     border: none; border-radius: 4px; cursor: pointer;
                     font-size: 0.9em; }}
  .download-button:hover {{ background-color: #45a049; }}
  .labels {{ background: #f8f9fa; padding: 10px; border-radius: 4px;
            margin-bottom: 15px; font-size: 0.9em; }}
  .model-name {{ font-weight: 500; color: #2c3e50; }}
  .meta {{ color: #868e96; font-size: 0.85em; margin-bottom: 16px; }}
</style>
<script>
function downloadCluster(clusterId, payload) {{
  const blob = new Blob([JSON.stringify(payload, null, 2)],
                        {{ type: 'application/json' }});
  const url = window.URL.createObjectURL(blob);
  const a = document.createElement('a');
  a.href = url;
  a.download = 'cluster-' + clusterId + '.json';
  document.body.appendChild(a);
  a.click();
  window.URL.revokeObjectURL(url);
  document.body.removeChild(a);
}}
</script>
</head>
<body>
<div class="container">
  <h1>Model Comparison</h1>
  <div class="meta">{meta}</div>
  {clusters}
</div>
</body>
</html>"""

_CLUSTER = """<div class="cluster">
  <h2>{heading}</h2>
  <div class="labels"><strong>Labels:</strong> {labels}</div>
  <table class="comparison-table">
    <thead>
      <tr><th>Model</th><th>Title</th><th>Catchy Phrase</th><th>Action</th></tr>
    </thead>
    <tbody>
      {rows}
    </tbody>
  </table>
  <div class="image-container">
    {images}
  </div>
</div>"""


def _js_payload(cluster_id: str, title: str, phrase: str,
                images: list[str], labels: str) -> str:
    """A single JSON argument for the download handler — structurally safer
    than the reference's five string-escaped args (utils.go:155)."""
    payload = {"title": title, "catchyPhrase": phrase,
               "images": images, "labels": labels}
    # json -> HTML attribute: escape quotes and tag-significant chars
    return html.escape(json.dumps(payload), quote=True)


def _image_url(image_route: str, name: str) -> str:
    """Build an image URL. ``image_route`` is either a prefix
    ("/api/image/") or a template with a "{name}" placeholder
    ("/api/image/{name}?job=abc") — the latter keeps a job-scoped report's
    images pointing at ITS job instead of whatever job is latest."""
    quoted = html.escape(name, quote=True)
    if "{name}" in image_route:
        return image_route.format(name=quoted)
    return image_route + quoted


def render_report(
    clusters: dict[str, ClusterDetails],
    image_route: str = "/api/image/",
    nav_html: str = "",
) -> str:
    cards = []
    for cluster_id in sorted(clusters, key=_cluster_sort_key):
        info = clusters[cluster_id]
        rows = []
        for out in info.service_outputs:
            payload = _js_payload(cluster_id, out.title, out.catchy_phrase,
                                  info.images, info.labels)
            rows.append(
                "<tr>"
                f'<td class="model-name">{html.escape(out.service_name)}</td>'
                f"<td>{html.escape(out.title)}</td>"
                f"<td>{html.escape(out.catchy_phrase)}</td>"
                "<td><button onclick=\"downloadCluster("
                f"'{html.escape(cluster_id, quote=True)}', {payload})\" "
                'class="download-button">Download Cluster</button></td>'
                "</tr>"
            )
        images = "".join(
            '<div class="image">'
            f'<img src="{_image_url(image_route, name)}" '
            'alt="Cluster image" loading="lazy"></div>'
            for name in info.images
        )
        heading = html.escape(info.title or cluster_id)
        cards.append(
            _CLUSTER.format(
                heading=heading,
                labels=html.escape(info.labels),
                rows="".join(rows) or "<tr><td colspan=4>No model outputs</td></tr>",
                images=images,
            )
        )
    meta = f"{len(clusters)} clusters"
    body = nav_html + "\n".join(cards) + nav_html
    return _PAGE.format(meta=html.escape(meta), clusters=body)


def _cluster_sort_key(cluster_id: str):
    # "Cluster-10" after "Cluster-2"
    tail = cluster_id.rsplit("-", 1)[-1]
    return (0, int(tail)) if tail.isdigit() else (1, cluster_id)


_DEFAULT_PAGE_SIZE = 500

# Above this many card pages the flat index (one <li> per page) is itself
# an unbounded document — a 10M-image job emits ~2.28M clusters = ~4,600
# pages. The index then goes TWO-LEVEL: clusters.html lists sections of up
# to _INDEX_FANOUT pages each (clusters_ix{s}.html), every section lists
# its pages. Two levels bound the 500-cards/page report to
# 200*200*500 = 20M clusters before a third level would be needed.
_INDEX_FANOUT = 200


def _page_url(page_route: str, page: int) -> str:
    return html.escape(page_route.format(page=page), quote=True)


def _write_atomic(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(content)
    os.replace(tmp, path)


def write_report(
    clusters: dict[str, ClusterDetails],
    out_dir: str,
    image_route: str = "/api/image/",
    page_size: int = _DEFAULT_PAGE_SIZE,
    page_route: str = "clusters_p{page}.html",
    index_route: str = "clusters.html",
    section_route: str = "clusters_ix{sec}.html",
    index_fanout: int | None = None,
) -> str:
    """Write <out_dir>/clusters.html (utils.go:205-211) and return its path.

    Up to ``page_size`` clusters, the report is the reference's single
    self-contained file. Beyond that — a 100k-image job yields ~21k
    clusters, a multi-tens-of-MB page no browser should be asked to open —
    clusters.html becomes an INDEX page and the cards are sharded into
    ``clusters_p{k}.html`` files of at most ``page_size`` clusters each,
    with index/prev/next navigation. Beyond ``index_fanout`` pages (the
    bucketed engine's 10M tier emits ~2.28M clusters = ~4,600 pages) the
    index itself goes two-level: clusters.html lists SECTIONS
    (``clusters_ix{s}.html``), each section lists its pages — every
    document the report emits is bounded. ``page_route``/``section_route``
    template the links ("clusters_p{page}.html" for file:// use;
    "/api/view?job=X&page={page}" / "...&sec={sec}" when served
    job-scoped)."""
    if index_fanout is None:  # read at call time (tests shrink it)
        index_fanout = _INDEX_FANOUT
    path = os.path.join(out_dir, "clusters.html")
    if len(clusters) <= page_size:
        _write_atomic(path, render_report(clusters, image_route))
        return path

    order = sorted(clusters, key=_cluster_sort_key)
    pages = [order[i:i + page_size] for i in range(0, len(order), page_size)]
    n_pages = len(pages)
    index_rows = []
    for k, ids in enumerate(pages, start=1):
        nav = ['<div class="meta">']
        nav.append(f'<a href="{html.escape(index_route, quote=True)}">'
                   "Index</a>")
        if k > 1:
            nav.append(f' | <a href="{_page_url(page_route, k - 1)}">'
                       "&laquo; Prev</a>")
        nav.append(f" | Page {k} of {n_pages}")
        if k < n_pages:
            nav.append(f' | <a href="{_page_url(page_route, k + 1)}">'
                       "Next &raquo;</a>")
        nav.append("</div>")
        page_clusters = {cid: clusters[cid] for cid in ids}
        _write_atomic(
            os.path.join(out_dir, f"clusters_p{k}.html"),
            render_report(page_clusters, image_route,
                          nav_html="".join(nav)),
        )
        n_images = sum(len(clusters[c].images) for c in ids)
        index_rows.append(
            f'<li><a href="{_page_url(page_route, k)}">Page {k}</a>: '
            f"{html.escape(ids[0])} &ndash; {html.escape(ids[-1])} "
            f"({len(ids)} clusters, {n_images} images)</li>"
        )
    total_images = sum(len(d.images) for d in clusters.values())
    summary = (f"{len(clusters)} clusters, {total_images} images — "
               f"paginated into {n_pages} pages of up to {page_size}")

    if n_pages <= index_fanout:  # flat single-level index
        index = _PAGE.format(
            meta=html.escape(summary),
            clusters='<ul class="labels">' + "".join(index_rows) + "</ul>",
        )
        _write_atomic(path, index)
        return path

    # two-level index: sections of up to index_fanout page rows each
    sections = [(s, index_rows[s * index_fanout:(s + 1) * index_fanout],
                 pages[s * index_fanout:(s + 1) * index_fanout])
                for s in range(-(-n_pages // index_fanout))]
    top_rows = []
    for s, rows, sec_pages in sections:
        first, last = sec_pages[0][0], sec_pages[-1][-1]
        n_sec_clusters = sum(len(ids) for ids in sec_pages)
        sec_url = html.escape(section_route.format(sec=s + 1), quote=True)
        nav = ('<div class="meta">'
               f'<a href="{html.escape(index_route, quote=True)}">Index</a>'
               f" | Section {s + 1} of {len(sections)}</div>")
        section_page = _PAGE.format(
            meta=html.escape(
                f"Section {s + 1}/{len(sections)}: pages "
                f"{s * index_fanout + 1}-{s * index_fanout + len(rows)} "
                f"({n_sec_clusters} clusters)"),
            clusters=nav + '<ul class="labels">' + "".join(rows) + "</ul>",
        )
        _write_atomic(os.path.join(out_dir, f"clusters_ix{s + 1}.html"),
                      section_page)
        top_rows.append(
            f'<li><a href="{sec_url}">Section {s + 1}</a>: '
            f"{html.escape(first)} &ndash; {html.escape(last)} "
            f"({n_sec_clusters} clusters, {len(sec_pages)} pages)</li>"
        )
    index = _PAGE.format(
        meta=html.escape(summary + f", indexed in {len(sections)} sections"),
        clusters='<ul class="labels">' + "".join(top_rows) + "</ul>",
    )
    _write_atomic(path, index)
    return path
