"""Standalone HTML map export.

Replaces the reference's folium/OpenStreetMap export (gpsui.py:420-453:
`showMap` renders the mean position + track into a temp HTML file and
opens a browser).  folium is not a baked-in dependency here, so the map
is written as a small self-contained Leaflet page (CDN assets, OSM
tiles) with the mean-position marker and the track polyline inlined.
"""

from __future__ import annotations

import json

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"/>
<title>gps_sdr fix</title>
<meta name="viewport" content="width=device-width, initial-scale=1.0"/>
<link rel="stylesheet"
 href="https://unpkg.com/leaflet@1.9.4/dist/leaflet.css"/>
<script src="https://unpkg.com/leaflet@1.9.4/dist/leaflet.js"></script>
<style>html,body,#map{{height:100%;margin:0}}</style>
</head><body><div id="map"></div><script>
var mean = {mean};
var track = {track};
var map = L.map('map').setView([mean[0], mean[1]], {zoom});
L.tileLayer('https://tile.openstreetmap.org/{{z}}/{{x}}/{{y}}.png',
  {{maxZoom: 19, attribution: '&copy; OpenStreetMap'}}).addTo(map);
L.marker([mean[0], mean[1]]).addTo(map)
  .bindPopup('mean fix: ' + mean[0].toFixed(6) + ', '
             + mean[1].toFixed(6) + ' (' + mean[2].toFixed(1) + ' m)');
if (track.length > 1)
  L.polyline(track, {{color: 'red', weight: 2}}).addTo(map);
</script></body></html>
"""


def save_map(path: str, mean_geo, geo_track=(), zoom: int = 17) -> str:
    """Write the map page; returns the path (open it in any browser)."""
    mean = [float(mean_geo[0]), float(mean_geo[1]), float(mean_geo[2])]
    track = [[float(lat), float(lon)] for lat, lon, *_ in geo_track]
    with open(path, "w") as f:
        f.write(_TEMPLATE.format(mean=json.dumps(mean),
                                 track=json.dumps(track), zoom=zoom))
    return path
